"""The port's ``preprocess/`` and its ``process`` command against the JAX
package's on the CPU: each processor (nnU-Net layout, with and without a
resize, seg-folder, VinDr box folder and the registry's recipes) run by
both packages over the same synthetic inputs (those of
tests/test_preprocess.py, tests/test_registry.py and
tests/test_boxes_fusion.py) must write the same files: ``sparse.json``,
``split.json`` and ``info.csv`` byte for byte, ``images.pt.zst``,
``masks.pt.zst`` and ``class_positions.npz`` array for array. The NIfTI and
DICOM readers, the box fusion, report sectioning and tagging give the same
values. ``chip_smoke.py``'s seg-exp configs are held to conf/seg-exp/*.yaml.
"""
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import mmmm_tpu.preprocess.boxes as jboxes
import mmmm_tpu.preprocess.dicom as jdicom
import mmmm_tpu.preprocess.processor as jproc
import mmmm_tpu.preprocess.registry as jreg
import mmmm_tpu.preprocess.report as jreport
import mmmm_tpu.preprocess.seg_folder as jseg
import mmmm_tpu.preprocess.tagging as jtag
import mmmm_tpu_torch.preprocess.boxes as tboxes
import mmmm_tpu_torch.preprocess.dicom as tdicom
import mmmm_tpu_torch.preprocess.processor as tproc
import mmmm_tpu_torch.preprocess.registry as treg
import mmmm_tpu_torch.preprocess.report as treport
import mmmm_tpu_torch.preprocess.seg_folder as tseg
import mmmm_tpu_torch.preprocess.tagging as ttag
from mmmm_tpu.preprocess import read_nifti as j_read_nifti
from mmmm_tpu.preprocess import write_nifti as j_write_nifti
from mmmm_tpu.utils import load_pt_zst
from mmmm_tpu_torch import cli
from mmmm_tpu_torch.preprocess import read_nifti, write_nifti

ROOT = Path(__file__).resolve().parent.parent


def assert_same_tree(a: Path, b: Path) -> None:
    """Every file under ``a`` is under ``b`` with the same content (arrays
    of ``.pt.zst`` and ``.npz`` files compared as arrays)."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        pa, pb = a / rel, b / rel
        if rel.name.endswith(".pt.zst"):
            xa, xb = load_pt_zst(pa), load_pt_zst(pb)
            assert xa.dtype == xb.dtype and xa.shape == xb.shape, rel
            np.testing.assert_array_equal(xa, xb, err_msg=str(rel))
        elif rel.suffix == ".npz":
            da, db = np.load(pa), np.load(pb)
            assert sorted(da.files) == sorted(db.files), rel
            for k in da.files:
                np.testing.assert_array_equal(da[k], db[k], err_msg=f"{rel}:{k}")
        else:
            assert pa.read_bytes() == pb.read_bytes(), rel


def _nnunet(root: Path, n_cases=2):
    """tests/test_preprocess.py's nnU-Net dataset."""
    (root / "imagesTr").mkdir(parents=True)
    (root / "labelsTr").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n_cases):
        vol = rng.normal(100, 20, size=(20, 24, 10)).astype(np.float32)
        seg = np.zeros((20, 24, 10), np.int16)
        seg[4:10, 4:12, 3:6] = 1
        seg[12:15, 14:20, 6:9] = 2
        seg[16:18, 2:5, 1:3] = 2
        affine = np.diag([1.0, 1.0, 5.0, 1.0])
        j_write_nifti(root / "imagesTr" / f"case{i}_0000.nii.gz", vol, affine)
        j_write_nifti(root / "labelsTr" / f"case{i}.nii.gz", seg, affine)
    (root / "dataset.json").write_text(json.dumps(
        {"labels": {"0": "background", "1": "liver", "2": "nodule"}}))
    return root


@pytest.mark.parametrize("edge", [64, 12])
def test_nnunet_processor_matches_jax(tmp_path, edge):
    """``max_smaller_edge`` 64 keeps the size; 12 resizes image and labels."""
    src = _nnunet(tmp_path / "Task_Demo")
    kw = dict(semantic={"liver": True, "nodule": False})
    for mod, out in ((jproc, "jax"), (tproc, "port")):
        conf = mod.ProcessorConfig(max_smaller_edge=edge, min_instance_voxels=4)
        info = mod.NNUNetProcessor(src, tmp_path / out, conf=conf, **kw).process()
        assert all(r["status"] == "ok" for r in info), info
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def _seg_folder(root: Path):
    rng = np.random.default_rng(3)
    for key in ("s0", "s1"):
        case = root / key
        (case / "segmentations").mkdir(parents=True)
        affine = np.diag([1.5, 1.5, 3.0, 1.0])
        j_write_nifti(case / "ct.nii.gz", rng.normal(0, 50, (18, 16, 8)).astype(np.float32),
                      affine)
        for name, sl in (("liver", np.s_[2:9, 3:10, 1:5]), ("kidney_left", np.s_[10:14, 2:6, 4:7])):
            m = np.zeros((18, 16, 8), np.uint8)
            m[sl] = 1
            j_write_nifti(case / "segmentations" / f"{name}.nii.gz", m, affine)
    return root


def test_seg_folder_processor_matches_jax(tmp_path):
    src = _seg_folder(tmp_path / "TotalSeg")
    for mod, pmod, out in ((jseg, jproc, "jax"), (tseg, tproc, "port")):
        info = mod.SegFolderProcessor(src, tmp_path / out,
                                      conf=pmod.ProcessorConfig(max_smaller_edge=64)).process()
        assert all(r["status"] == "ok" for r in info), info
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def _vindr(src: Path):
    """tests/test_boxes_fusion.py's VinDr-style folder."""
    rng = np.random.default_rng(1)
    (src / "train").mkdir(parents=True)
    for key in ("s0", "s1", "s2"):
        Image.fromarray(rng.integers(0, 255, size=(64, 48), dtype=np.uint8).copy(), "L").save(
            src / "train" / f"{key}.png")
    (src / "annotations_train.csv").write_text(
        "image_id,class_name,rad_id,x_min,y_min,x_max,y_max\n"
        "s0,Nodule/Mass,R1,10,12,20,22\n"
        "s0,Nodule/Mass,R2,11,12,21,23\n"
        "s0,Cardiomegaly,R1,5,30,40,60\n"
        "s1,No finding,R1,,,,\n"
        "s2,No finding,R3,,,,\n"
        "s2,Aortic enlargement,R1,8,8,16,16\n")
    return src


def test_box_fusion_and_box_folder_processor_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (9, 2))], -1)
    rads = np.asarray([f"r{i % 3}" for i in range(9)])
    np.testing.assert_array_equal(tboxes.fuse_annotator_boxes(boxes, rads),
                                  jboxes.fuse_annotator_boxes(boxes, rads))
    a, b = rng.uniform(0, 10, (5, 4)), rng.uniform(0, 10, (3, 4))
    np.testing.assert_array_equal(tboxes.box_iou_2d(a, b), jboxes.box_iou_2d(a, b))
    src = _vindr(tmp_path / "vindr")
    jc, tc = jboxes.load_box_cases(src), tboxes.load_box_cases(src)
    assert [(c.key, c.annotations, c.neg_classes) for c in jc] == [
        (c.key, c.annotations, c.neg_classes) for c in tc]
    jboxes.BoxFolderProcessor("VinDr-demo", jc, tmp_path / "jax").process()
    tboxes.BoxFolderProcessor("VinDr-demo", tc, tmp_path / "port").process()
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_registry_recipes_and_dispatch_match_jax(tmp_path):
    assert set(treg.REGISTRY) == set(jreg.REGISTRY)
    for name, r in jreg.REGISTRY.items():
        assert treg.REGISTRY[name].__dict__ == r.__dict__, name
    src = _vindr(tmp_path / "vindr")
    for mod, pmod, out in ((jreg, jproc, "jax"), (treg, tproc, "port")):
        mod.build_processor("VinDr-CXR", src, tmp_path / out, pmod.ProcessorConfig()).process()
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_process_command_matches_jax_script(tmp_path, capsys):
    src = _nnunet(tmp_path / "Task_X")
    sys.path.insert(0, str(ROOT / "scripts" / "data"))
    try:
        import process as jax_process
    finally:
        sys.path.pop(0)
    argv = ["--layout", "nnunet", "--src", str(src), "--max-smaller-edge", "64"]
    jax_process.main([*argv, "--out", str(tmp_path / "jax")])
    jax_line = capsys.readouterr().out
    args = cli.parse_args(["process", *argv, "--out", str(tmp_path / "port")])
    info = args.func(args)
    assert capsys.readouterr().out == jax_line == "Task_X: 2 processed, 0 existing, 0 failed/skipped\n"
    assert [r["status"] for r in info] == ["ok", "ok"]
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    # a second run finds the cases and skips them
    args.func(args)
    assert "0 processed, 2 existing" in capsys.readouterr().out


def test_nifti_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(5)
    affine = np.diag([1.5, 0.7, 0.7, 1.0])
    affine[:3, 3] = [10, -5, 3]
    for dtype in (np.uint8, np.int16, np.float32):
        data = rng.uniform(0, 100, size=(7, 9, 5)).astype(dtype)
        write_nifti(tmp_path / "p.nii.gz", data, affine)
        j_write_nifti(tmp_path / "j.nii.gz", data, affine)
        assert (tmp_path / "p.nii.gz").read_bytes() == (tmp_path / "j.nii.gz").read_bytes()
        a, b = read_nifti(tmp_path / "j.nii.gz"), j_read_nifti(tmp_path / "p.nii.gz")
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.affine, b.affine)


def _dicom_bytes(rows=4, cols=5, slope=2.0, intercept=-10.0, z=0.0):
    """A minimal explicit-VR little-endian DICOM file with 16-bit pixels."""
    def el(group, elem, vr, value: bytes) -> bytes:
        if vr in (b"OB", b"OW", b"SQ", b"UN"):
            return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
        return struct.pack("<HH2sH", group, elem, vr, len(value)) + value

    def s(text: str) -> bytes:
        b = text.encode()
        return b + b" " * (len(b) % 2)

    pixels = (np.arange(rows * cols, dtype=np.uint16) * 3).tobytes()
    meta = el(0x0002, 0x0010, b"UI", s("1.2.840.10008.1.2.1"))
    body = b"".join([
        el(0x0020, 0x0032, b"DS", s(f"0\\0\\{z}")), el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        el(0x0028, 0x0030, b"DS", s("0.5\\0.5")),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        el(0x0028, 0x1052, b"DS", s(str(intercept))), el(0x0028, 0x1053, b"DS", s(str(slope))),
        el(0x7FE0, 0x0010, b"OW", pixels)])
    return b"\x00" * 128 + b"DICM" + meta + body


def test_dicom_reader_matches_jax(tmp_path):
    series = tmp_path / "series"
    series.mkdir()
    for i, z in enumerate((2.0, 0.0, 1.0)):
        (series / f"im{i}.dcm").write_bytes(_dicom_bytes(z=z))
    ja = jdicom.read_dicom_file(series / "im0.dcm")
    ta = tdicom.read_dicom_file(series / "im0.dcm")
    np.testing.assert_array_equal(ta[0], ja[0])
    assert ta[1] == ja[1]
    jv, js = jdicom.read_dicom_series(series)
    tv, ts = tdicom.read_dicom_series(series)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts, js)


REPORT = ("EXAMINATION: CHEST (PA AND LAT)\nINDICATION: cough.\nCOMPARISON: Prior study of "
          "___.\nFINDINGS: There is mild cardiomegaly, unchanged since the prior exam. A small "
          "left pleural effusion is present.  No pneumothorax.\nIMPRESSION: Cardiomegaly and "
          "small left effusion. Dr. ___ was notified by phone.")


def test_report_and_tagging_match_jax():
    assert treport.split_sections(REPORT) == jreport.split_sections(REPORT)
    for clean in (True, False):
        assert (treport.extract_findings_impression(REPORT, clean)
                == jreport.extract_findings_impression(REPORT, clean))
    fi = jreport.extract_findings_impression(REPORT)
    assert (treport.build_processed_report(fi["findings"], fi["impression"])
            == jreport.build_processed_report(fi["findings"], fi["impression"]))
    text = jreport.build_processed_report(fi["findings"], fi["impression"])
    from mmmm_tpu.data.target_tax import get_target_tax as j_tax
    from mmmm_tpu_torch.data.target_tax import get_target_tax as t_tax

    tags = ttag.TaxonomyTagger(t_tax()).tag(text)
    assert tags and tags == jtag.TaxonomyTagger(j_tax()).tag(text)
    linked = text.replace("cardiomegaly", "<p>cardiomegaly</p>[cardiomegaly]", 1)
    assert ttag.parse_linked_report(text, linked) == jtag.parse_linked_report(text, linked)


@pytest.mark.parametrize("with_examples", [False, True])
def test_llm_tagger_prompts_match_jax(with_examples):
    """Both packages' ``LLMTagger`` hand a recording ``generate_fn`` the same
    prompts, byte for byte, in the tagging pass and in the filter pass, with
    and without few-shot ``examples``; the tags parsed from its answers are
    the same."""
    text = jreport.build_processed_report(**{
        k: v for k, v in jreport.extract_findings_impression(REPORT).items()
        if k in ("findings", "impression")})
    targets = ["heart", "left pleural effusion", "pneumothorax"]
    examples = ([("Mild cardiomegaly.", "Mild [cardiomegaly](heart).")] if with_examples
                else None)
    answer = text.replace("cardiomegaly", "[cardiomegaly](heart)", 1)
    prompts = {}
    for name, mod in (("jax", jtag), ("port", ttag)):
        seen = prompts[name] = []

        def generate(batch, seen=seen):
            seen.append(list(batch))
            return [answer for _ in batch]

        tags = mod.LLMTagger(generate, targets, examples=examples).tag_batch([text, text])
        assert tags == [jtag.parse_linked_report(text, answer)] * 2
    assert len(prompts["port"]) == 2  # the tagging pass, then the filter pass
    assert [[p.encode() for p in b] for b in prompts["port"]] == \
        [[p.encode() for p in b] for b in prompts["jax"]]
    assert ttag._FILTER_INSTRUCTIONS.encode() == jtag._FILTER_INSTRUCTIONS.encode()


def test_chip_smoke_seg_exp_configs_mirror_the_yaml():
    """chip_smoke.py writes conf/seg-exp/{unet,sam}.yaml as dicts (the
    card's machine has no PyYAML)."""
    import chip_smoke
    from mmmm_tpu_torch.config import load_yaml

    assert chip_smoke.SEG_EXP_UNET == load_yaml(ROOT / "conf" / "seg-exp" / "unet.yaml")
    assert chip_smoke.SEG_EXP_SAM == load_yaml(ROOT / "conf" / "seg-exp" / "sam.yaml")
