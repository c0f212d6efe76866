"""The port's training step in instance grounding mode against
``mmmm_tpu.train.make_train_step``: boxes only (the VinDr bucket) and with
``masks_label`` (the label masks downsampled by ``nearest_resize``), with
the batch, steps and tolerances of tests/test_torch_port_train.py. The
Hungarian match may pick another of two tied negative columns; losses and
gradients do not depend on which."""
import pytest
import torch

from test_torch_port_train import check_steps, jax_run, port_step, train_batch
from test_torch_port_models import one_thread  # noqa: F401

# each JAX reference (one compile each) is held against all four port
# combinations of attention route and remat
JAX_REFS = {"instance_boxes": ("instance", False, "xla", False),
            "instance_masks": ("instance", True, "pallas", False)}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(JAX_REFS))
def test_instance_train_step_matches_jax(case, attn, remat):
    mode, with_masks, jattn, jremat = JAX_REFS[case]
    states, frozen, ref_logs = jax_run(mode, with_masks, jattn, jremat)
    check_steps(states, frozen, ref_logs, port_step(mode, attn, remat),
                train_batch(mode, with_masks))
