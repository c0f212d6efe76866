"""The port's GPipe pipeline (``parallel/pipeline.py``) and its
pipeline-parallel training against the JAX package's, on the CPU.

  - In one process: tests/test_pipeline.py's toy layers (tanh of an affine
    map, gated) through the port's schedule with its stages in lockstep
    (``VirtualPipe``), 8 layers over 4 stages in 4 microbatches and 4 over
    4 in 2, against JAX's ``pipeline_layers`` on the virtual mesh: outputs,
    and the gradients of the layers and of the input, within 1e-5.
  - Over 4 gloo processes (one launch of ``test_torch_port_ring.py
    MESH_WORKER``): the tiny model's train step (its LLM made 4 layers deep,
    as tests/test_pipeline.py makes it; 4 rows, so each data rank's 2 rows
    make ``pipe_micro=2`` microbatches) on a ``(data=2, pipe=2)`` mesh
    against JAX's step on the same virtual mesh under its pipe context and
    against the port's one-process step: loss within 1e-4 relative and
    trainable leaves within 2e-5; ``llm_forward`` under the pipe context
    where ``pipe_ready`` is false (3 rows do not split into 2 microbatches)
    equal to the local route, the gradient of a staged leaf its stage's
    rows of the local route's; and ``fit`` at conf/tiny/fit.yaml with
    ``trainer.mesh_pipe=2`` (``pipe_micro=1``) against the fit without a
    mesh: every line of ``metrics.jsonl`` within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.parallel import make_mesh as jax_make_mesh
from mmmm_tpu.parallel.pipeline import pipeline_layers as jax_pipeline_layers
from mmmm_tpu.parallel.pipeline import set_pipe_context as jax_set_pipe_context
from mmmm_tpu_torch.parallel.pipeline import VirtualPipe, get_pipe_context
from test_torch_port_models import one_thread  # noqa: F401
from test_torch_port_ring import check_mesh_runs, jax_step_leaves, mesh_runs
from test_torch_port_train import train_batch


def _toy(seed: int, n_layers: int, b: int, s: int, c: int = 16):
    rng = np.random.default_rng(seed)
    layers = {"w": (rng.normal(size=(n_layers, c, c)) * 0.1).astype(np.float32),
              "b": (rng.normal(size=(n_layers, c)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    gate = np.ones((b, s), np.float32)
    gate[:, -1] = 0.5
    return layers, x, gate


def _jax_toy_layer(h, lp, side):
    return jnp.tanh(h @ lp["w"] + lp["b"]) * side["gate"][:, :, None]


@pytest.mark.parametrize("n_layers,b,n_micro,data", [(8, 8, 4, 2), (4, 4, 2, 1)],
                         ids=["8-layers-4-micro", "4-layers-2-micro"])
def test_toy_layers_through_the_schedule_match_jax_pipeline(n_layers, b, n_micro, data):
    layers, x, gate = _toy(n_layers, n_layers, b, 5)
    mesh = jax_make_mesh(data=data, pipe=4)

    def jax_loss(lp, xx):
        out = jax_pipeline_layers(_jax_toy_layer, lp, xx, {"gate": jnp.asarray(gate)}, mesh,
                                  "pipe", n_micro=n_micro)
        return jnp.sum(out ** 2), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        layers, x)
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in layers.items()}
    tx = torch.tensor(x, requires_grad=True)
    per = n_layers // 4

    def stage(s, h, side):
        for i in range(s * per, (s + 1) * per):
            h = torch.tanh(h @ tl["w"][i] + tl["b"][i]) * side["gate"][:, :, None]
        return h

    got = VirtualPipe(4).run(stage, tx, {"gate": torch.tensor(gate)}, n_micro)
    grads = torch.autograd.grad((got ** 2).sum(), (tl["w"], tl["b"], tx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("w", "b", "x"), grads, (jgrads[0]["w"], jgrads[0]["b"], jgrads[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


def _jax_pipe_steps(state, frozen, batch):
    mesh = jax_make_mesh(data=2, pipe=2)
    jax_set_pipe_context(mesh, "pipe", n_micro=2)
    try:
        return jax_step_leaves(mesh, state, frozen, batch, "xla", deep_llm=True)
    finally:
        jax_set_pipe_context(None)


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_mesh")
    # 4 rows: 2 a data rank, 2 microbatches of 1
    rows = [train_batch("none", seed=i) for i in range(2)]
    batch = {k: np.concatenate([r[k] for r in rows]) if isinstance(v, np.ndarray) else v
             for k, v in rows[0].items()}
    return tmp, *mesh_runs(tmp, {"data": 2, "pipe": 2}, batch,
                           ["trainer.mesh_pipe=2", "trainer.pipe_micro=1"], _jax_pipe_steps,
                           pipe_micro=2, unready=True, deep=True)


def test_pipe_step_matches_jax_pipeline_step_and_one_process(pipe_runs):
    tmp, port, ref, fits = pipe_runs
    check_mesh_runs(tmp, port, ref, fits)
    assert get_pipe_context() is None  # set in the processes only
    # every LLM layer leaf of the trainable tree (the LoRA factors) staged
    assert all(r["staged"] == port[0]["staged"] > 0 for r in port)


def test_llm_forward_where_the_pipeline_cannot_run_gathers_the_stages(pipe_runs):
    _, port, _, _ = pipe_runs
    for r in port:
        assert r["unready"]["staged"]
        assert r["unready"]["err"] <= 1e-6 and r["unready"]["grad_err"] <= 1e-6
