"""A ``params.npz`` written by the JAX package's ``scripts/data/detector.py
train`` read by the port's ``detector-infer`` (``--device cpu``): the same
``{stem}_box.json`` keys as the JAX script's ``infer`` over the same
checkpoint, boxes within 1e-3 px. The JAX training step's compile takes
most of this file's time, so it has a file of its own."""
import sys
from pathlib import Path

import pytest
import torch

from mmmm_tpu_torch import cli
from test_torch_port_detector_cli import (SMALL, assert_boxes_close, infer_args,
                                          write_processed, write_studies)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jax_checkpoint_loads_in_port_infer(tmp_path):
    sys.path.insert(0, str(ROOT / "scripts" / "data"))
    try:
        import detector as jax_det_cli
    finally:
        sys.path.pop(0)
    proc = write_processed(tmp_path, n=3)
    ckpt = tmp_path / "ckpt_jax"
    jax_det_cli.main(["train", "--data", str(proc), "--out", str(ckpt), "--steps", "1",
                      "--batch", "2", "--eval-frac", "0", *SMALL])
    tags = write_studies(tmp_path)
    jax_out, port_out = tmp_path / "boxes_jax", tmp_path / "boxes_port"
    jax_det_cli.main(["infer", *infer_args(ckpt, tags, jax_out)])
    args = cli.parse_args(["detector-infer", *infer_args(ckpt, tags, port_out), "--device", "cpu"])
    assert args.func(args) == 2
    assert_boxes_close(port_out, jax_out)
