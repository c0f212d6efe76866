"""TotalSegmentator-style processor: per-class mask files per case.

Layout: ``<root>/<case>/ct.nii.gz`` + ``<root>/<case>/segmentations/
<class>.nii.gz`` (one binary mask per anatomical class). This is the second
common raw layout after nnU-Net's integer label maps and covers
TotalSegmentator and similarly organized in-house datasets
(reference: ``scripts/data/local/processors/TotalSegmentator*.py``).

The port's own copy of ``mmmm_tpu/preprocess/seg_folder.py``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .nifti import read_nifti
from .processor import CaseSpec, Processor, ProcessorConfig, SkipCase, reorient_to_dhw


class SegFolderProcessor(Processor):
    def __init__(
        self,
        dataset_dir: Path,
        output_root: Path,
        *,
        name: str | None = None,
        modality: str = "CT",
        image_name: str = "ct.nii.gz",
        seg_dir: str = "segmentations",
        class_name_map: dict[str, str] | None = None,  # file stem -> taxonomy name
        conf: ProcessorConfig | None = None,
    ):
        self.dataset_dir = Path(dataset_dir)
        self.name = name or self.dataset_dir.name
        self.modality = modality
        self.image_name = image_name
        self.seg_dir = seg_dir
        self.class_name_map = class_name_map or {}
        super().__init__(output_root, conf)

    def get_cases(self) -> list[CaseSpec]:
        cases = []
        for case_dir in sorted(self.dataset_dir.iterdir()):
            img = case_dir / self.image_name
            if img.exists():
                cases.append(CaseSpec(key=case_dir.name, images={self.modality: img}))
        return cases

    def process_case(self, case: CaseSpec) -> dict:
        # assemble an integer label map from the per-class binary masks, then
        # reuse the base pipeline
        case_dir = self.dataset_dir / case.key
        seg_dir = case_dir / self.seg_dir
        masks = sorted(seg_dir.glob("*.nii*")) if seg_dir.exists() else []
        if not masks:
            raise SkipCase("no segmentations")
        label_map = None
        class_map: dict[int, str] = {}
        affine = None
        for value, mask_path in enumerate(masks, start=1):
            stem = mask_path.name.replace(".nii.gz", "").replace(".nii", "")
            img = read_nifti(mask_path)
            data = img.data.astype(bool)
            if label_map is None:
                label_map = np.zeros(data.shape, np.int16)
                affine = img.affine
            if data.shape != label_map.shape:
                raise SkipCase(f"mask shape mismatch: {mask_path.name}")
            label_map[data] = value
            class_map[value] = self.class_name_map.get(stem, stem.replace("_", " "))

        # write the combined label map next to the temp output for the base
        # pipeline to consume (kept out of the final dir)
        from .nifti import write_nifti

        tmp_seg = self.output_dir / f".{case.key}_seg.nii.gz"
        tmp_seg.parent.mkdir(parents=True, exist_ok=True)
        write_nifti(tmp_seg, label_map, affine)
        try:
            case = CaseSpec(
                key=case.key,
                images=case.images,
                seg=tmp_seg,
                class_map=class_map,
                semantic={name: True for name in class_map.values()},
            )
            return super().process_case(case)
        finally:
            tmp_seg.unlink(missing_ok=True)
