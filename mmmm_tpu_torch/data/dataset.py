"""Multi-dataset assembly: specs -> data lists -> transform dispatch.

Equivalent of ``MMMMDataset`` (``mmmm/data/dataset/_dataset.py``): an index is
(dataset_idx, sub_idx); the sample routes through the transform family of the
dataset's type (local / vl / grg). Produces an infinite transformed-sample
stream when driven by the weighted sampler.

The port's own copy of ``mmmm_tpu/data/dataset.py``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

from .defs import Split
from .grg import GRGTransform, get_grg_data_list
from .local import DatasetConf, LocalTransform, get_local_data_list
from .sampling import DatasetSpec as SamplerSpec, WeightedMultiDatasetSampler, sample_rng
from .tokenizer import MMMMTokenizer
from .vl import VLTransform, get_vl_data_list


@dataclasses.dataclass
class DatasetSpec:
    name: str
    type: str  # local | vl | grg
    dir: str | Path | None = None  # defaults to the processed root / name
    weight: float = 1.0


class MultiDataset:
    def __init__(
        self,
        conf: DatasetConf,
        specs: list[DatasetSpec],
        tokenizer: MMMMTokenizer,
        split: Split = Split.TRAIN,
        inference: bool = False,
        seed: int | None = None,
        target_tax: dict | None = None,
        skip_missing: bool = False,
    ):
        from .defs import (
            PROCESSED_LOCAL_DATA_ROOT,
            PROCESSED_VG_DATA_ROOT,
            PROCESSED_VL_DATA_ROOT,
        )

        roots = {
            "local": PROCESSED_LOCAL_DATA_ROOT,
            "vl": PROCESSED_VL_DATA_ROOT,
            "grg": PROCESSED_VG_DATA_ROOT,
        }
        self.conf = conf
        self.data_lists = []
        kept, skipped = [], []
        for spec in specs:
            d = Path(spec.dir) if spec.dir else roots[spec.type] / spec.name
            if skip_missing and not d.exists():
                # roster-with-partial-data policy: the phase configs ship the
                # FULL reference rosters (conf/phase-*/data.yaml); train on
                # whichever subset exists on disk
                skipped.append(spec.name)
                continue
            if spec.type == "local":
                self.data_lists.append(get_local_data_list(d, split))
            elif spec.type == "vl":
                self.data_lists.append(get_vl_data_list(d, split))
            elif spec.type == "grg":
                self.data_lists.append(get_grg_data_list(d, split))
            else:
                raise ValueError(spec.type)
            kept.append(spec)
        if skipped:
            if not kept and specs:
                raise FileNotFoundError(
                    f"none of the {len(specs)} configured datasets exist on disk "
                    f"(missing: {', '.join(skipped)})"
                )
            import sys

            print(
                f"[mmmm_tpu_torch.data] skipping {len(skipped)} dataset(s) without "
                f"processed data on disk: {', '.join(skipped)}",
                file=sys.stderr,
            )
        self.specs = kept
        # MIMIC-CXR negative-report reweighting (ref datamodule.py:48-62):
        # per-sample multinomial weights giving no-anomaly reports a target
        # share of conf.mimic_cxr_neg_weight within the dataset
        self.sample_weights: list = [None] * len(self.specs)
        if (w := getattr(conf, "mimic_cxr_neg_weight", None)) is not None:
            assert 0 <= w <= 1
            from .sampling import mimic_neg_weights
            import numpy as np

            for i, spec in enumerate(self.specs):
                if spec.name == "MIMIC-CXR":
                    has_anomaly = np.asarray(
                        [len(d.get("anomaly_pos") or []) > 0 for d in self.data_lists[i]]
                    )
                    self.sample_weights[i] = mimic_neg_weights(has_anomaly, w)
        self.transforms = {}
        if any(s.type == "local" for s in self.specs):
            self.transforms["local"] = LocalTransform(conf, tokenizer, inference, target_tax, seed)
        if any(s.type == "vl" for s in self.specs):
            self.transforms["vl"] = VLTransform(conf, tokenizer, inference, target_tax, seed)
        if any(s.type == "grg" for s in self.specs):
            self.transforms["grg"] = GRGTransform(conf, tokenizer, inference, seed)

    def sizes(self) -> list[int]:
        return [len(dl) for dl in self.data_lists]

    def get(self, dataset_idx: int, sub_idx: int, rng=None) -> dict:
        spec = self.specs[dataset_idx]
        return self.transforms[spec.type](self.data_lists[dataset_idx][sub_idx], rng=rng)

    def plan(self, dataset_idx: int, sub_idx: int, rng) -> dict:
        """Metadata-only transform pass: bucket key without pixel IO."""
        spec = self.specs[dataset_idx]
        return self.transforms[spec.type](
            self.data_lists[dataset_idx][sub_idx], rng=rng, plan_only=True
        )

    def plan_stream(self, num_samples: int, seed: int = 42) -> Iterator[dict]:
        """The GLOBAL (unsharded) plan stream — identical on every process.

        Each plan carries a ``ref`` = (dataset_idx, sub_idx, stream position)
        from which any rank can materialize the sample bit-identically via
        the per-sample RNG (``sampling.sample_rng``)."""
        sampler = WeightedMultiDatasetSampler(
            [SamplerSpec(s.name, s.weight, sample_weights=sw)
             for s, sw in zip(self.specs, self.sample_weights)],
            self.sizes(),
            num_samples,
            seed=seed,
        )
        for pos, (ds, sub) in enumerate(sampler):
            plan = self.plan(ds, sub, sample_rng(seed, pos))
            plan["ref"] = (ds, sub, pos, seed)
            yield plan

    def materialize(self, plan: dict) -> dict:
        ds, sub, pos, seed = plan["ref"]
        dp = self.get(ds, sub, rng=sample_rng(seed, pos))
        expected = tuple(plan["image_shape"])
        got = (dp["image"].shape, len(dp["vlm_inputs"].input_ids), dp["grounding"], dp["instance"])
        want = (expected, plan["seq_len"], plan["grounding"], plan["instance"])
        assert got == want, (
            f"plan/materialize divergence for {plan['src']}: planned "
            f"(shape, seq, grounding, instance)={want}, materialized {got}"
        )
        return dp

    def stream(
        self, num_samples: int, seed: int = 42, rank: int = 0, world_size: int = 1
    ) -> Iterator[dict]:
        sampler = WeightedMultiDatasetSampler(
            [SamplerSpec(s.name, s.weight, sample_weights=sw)
             for s, sw in zip(self.specs, self.sample_weights)],
            self.sizes(),
            num_samples,
            seed=seed,
            rank=rank,
            world_size=world_size,
        )
        for ds, sub in sampler:
            yield self.get(ds, sub)
