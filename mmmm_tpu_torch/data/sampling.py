"""Weighted multi-dataset sampling (``mmmm/data/datamodule.py:41-85``).

Dataset choice: multinomial over (spec.weight * len(dataset)); within-dataset
order: reshuffled epoch buffers (or weighted buffers when per-sample weights
are given — the MIMIC-CXR negative-report reweighting hook). Per-host
sharding replaces ``DistributedSamplerWrapper``: host ``rank`` takes every
``world_size``-th index of the same deterministic stream, so hosts never
overlap and no coordination is needed.

The port's own copy of ``mmmm_tpu/data/sampling.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    name: str
    weight: float = 1.0
    sample_weights: np.ndarray | None = None  # optional per-sample weights


class WeightedMultiDatasetSampler:
    def __init__(
        self,
        specs: Sequence[DatasetSpec],
        sizes: Sequence[int],
        num_samples: int,
        seed: int = 42,
        rank: int = 0,
        world_size: int = 1,
    ):
        assert len(specs) == len(sizes)
        self.specs = list(specs)
        self.sizes = list(sizes)
        self.num_samples = num_samples
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __len__(self) -> int:
        return self.num_samples // self.world_size

    def __iter__(self) -> Iterator[tuple[int, int]]:
        R = np.random.RandomState(self.seed)
        weights = np.asarray([s.weight * n for s, n in zip(self.specs, self.sizes)], np.float64)
        probs = weights / weights.sum()
        choices = R.choice(len(self.specs), size=self.num_samples, p=probs)
        buffers = [np.empty(0, np.int64) for _ in self.specs]
        cursors = [0] * len(self.specs)
        for pos, ds in enumerate(choices):
            if cursors[ds] == len(buffers[ds]):
                spec = self.specs[ds]
                if spec.sample_weights is not None:
                    w = np.asarray(spec.sample_weights, np.float64)
                    buffers[ds] = R.choice(self.sizes[ds], size=131072, p=w / w.sum())
                else:
                    buffers[ds] = R.permutation(self.sizes[ds])
                cursors[ds] = 0
            sub = int(buffers[ds][cursors[ds]])
            cursors[ds] += 1
            if pos % self.world_size == self.rank:
                yield int(ds), sub


def sample_rng(seed: int, pos: int) -> np.random.RandomState:
    """Per-sample RandomState derived from (stream seed, stream position).

    Every process derives the SAME generator for the same sample, which makes
    transform decisions (and hence bucket keys) host-invariant — the
    load-bearing property for the multi-host batch schedule (every rank must
    reach the jitted step with the same bucket shapes/modes in the same
    order; cf. the reference's DDP dummy-forward hazard,
    ``mmmm/models/mmmm.py:263-278``)."""
    return np.random.RandomState(np.random.SeedSequence([seed, pos]).generate_state(4))


def mimic_neg_weights(has_anomaly: np.ndarray, neg_weight: float) -> np.ndarray:
    """Per-sample weights giving negative (no-anomaly) reports a target share
    ``neg_weight`` of the dataset (``datamodule.py:49-62``)."""
    has_anomaly = np.asarray(has_anomaly, bool)
    n = len(has_anomaly)
    n_neg = int((~has_anomaly).sum())
    w = np.ones(n)
    if 0 < n_neg < n:
        w[~has_anomaly] = (neg_weight * (n - n_neg)) / ((1 - neg_weight) * n_neg)
    return w
