"""Shared fixtures of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests -q``). The tests marked ``cuda``
decide inside the test whether a card is there and skip without one."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def small_spec():
    """A cell at widths a CPU test holds: the serving traffic and the
    model's layers, every int4 weight shape a multiple of 256."""
    return {"cell": {"name": "small", "chips": 1},
            "cfg": json.loads((DATA / "small.json").read_text()),
            "traffic": json.loads((DATA / "small_spec.json").read_text()),
            "end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "reports_per_s", "unit": "reports/s"}],
            "per_layer": [{"name": "mfu.serve", "unit": "%"},
                          {"name": "tokens_per_verify_step", "unit": "tokens/step"}]}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
