"""The port's ring attention (``parallel/ring_attention.py``) and its
sequence-parallel training against the JAX package's, on the CPU.

  - In one process: the ring's 4 virtual ranks (``ring_attention_virtual``,
    the per-rank steps in lockstep) against JAX's ``ring_segment_attention``
    on the virtual 4-device mesh, over tests/test_ring_attention.py's data
    (two segments and 8 padding tokens): values, causal and not, within
    2e-5 in fp32 and 0.05 in bf16; gradients of q, k and v within 5e-5;
    padding rows, and a sequence that is all padding, exactly 0. The
    ``"ring"`` route of ``segment_attention``, and of ``attention`` without
    a ring context, takes ``"auto"``.
  - Over 4 gloo processes (one launch, :data:`MESH_WORKER`): the tiny
    model's train step on a ``(data=2, seq=2)`` mesh (``attn_impl="ring"``
    under ``set_ring_context``: the LLM's 32 tokens ring, the ViT's 17 take
    ``"auto"``) against JAX's step on the same virtual mesh and against the
    port's one-process step: loss within 1e-4 relative and trainable leaves
    within 2e-5 after one step, tests/test_ring_attention.py's bounds; and
    ``fit`` at conf/tiny/fit.yaml with ``trainer.mesh_seq=2`` against the fit
    without a mesh: every line of ``metrics.jsonl`` within 1e-5.

Every process has a timeout of its own (``test_torch_port_parallel.py
wait_processes``), so a hang fails in minutes.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import MMMMModel
from mmmm_tpu.ops.attention import segment_attention as jax_segment_attention
from mmmm_tpu.parallel import make_mesh as jax_make_mesh
from mmmm_tpu.parallel.ring_attention import ring_segment_attention as jax_ring
from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.peft import lora as jlora
from mmmm_tpu.train import OptimizerConfig as JaxOptimizerConfig
from mmmm_tpu.train import make_optimizer as jax_make_optimizer
from mmmm_tpu.train import make_train_step as jax_make_train_step
from mmmm_tpu.train.step import TrainState as JaxTrainState
from mmmm_tpu_torch import MMMMConfig, cli
from mmmm_tpu_torch.ops.attention import segment_attention
from mmmm_tpu_torch.parallel.ring_attention import (attention, get_ring_context, merge,
                                                    ring_attention_virtual)
from mmmm_tpu_torch.peft.lora import flatten
from test_torch_port_models import numpy_params, one_thread  # noqa: F401
from test_torch_port_parallel import start_processes, wait_processes
from test_torch_port_train import LORA, OPT, jax_state0, train_batch

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"


def _data(seed=0, b=2, s=64, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    seg[:, :40] = 1
    seg[:, 40:56] = 2  # trailing 8 tokens padding
    return q, k, v, seg


def _jax_mesh4():
    return jax_make_mesh(data=1, model=4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_virtual_ranks_match_jax_ring(causal, dtype):
    q, k, v, seg = _data()
    want = jax.jit(lambda q, k, v, s: jax_ring(q, k, v, s, _jax_mesh4(), "model", causal=causal))(
        *(jnp.asarray(t, dtype) for t in (q, k, v)), jnp.asarray(seg))
    tq, tk, tv = (torch.tensor(t).to(getattr(torch, dtype)) for t in (q, k, v))
    got = ring_attention_virtual(tq, tk, tv, torch.tensor(seg), 4, causal=causal)
    assert got.dtype == tq.dtype
    tol = 2e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert not got[:, 56:].any()  # padding rows
    # the merge hands K7 contiguous shards, as the kernels take them
    parts = [(got[:, :16], torch.zeros((2, 2, 16)), torch.ones((2, 16), dtype=torch.bool))] * 2
    assert all(t.is_contiguous() for t in merge(parts, got.dtype))


def test_ring_virtual_gradients_match_jax_ring():
    q, k, v, seg = _data(seed=1)

    def jax_loss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, jnp.asarray(seg), _jax_mesh4(), "model",
                                causal=True) ** 2)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = ring_attention_virtual(tq, tk, tv, torch.tensor(seg), 4, causal=True)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5,
                                   err_msg=f"d{name}")


def test_ring_masked_rows_zero_and_the_route_without_a_context():
    q, k, v, _ = (torch.tensor(t) for t in _data(seed=2))
    pad = torch.zeros(q.shape[:2], dtype=torch.int32)
    for causal in (False, True):
        out = ring_attention_virtual(q, k, v, pad, 4, causal=causal)
        assert torch.equal(out, torch.zeros_like(out))
    seg = torch.tensor(_data()[3])
    assert get_ring_context() is None
    auto = segment_attention(q, k, v, seg, causal=True, impl="auto")
    for fn in (segment_attention, attention):
        torch.testing.assert_close(fn(q, k, v, seg, causal=True, impl="ring"), auto,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible by ring size 3"):
        ring_attention_virtual(q, k, v, seg, 3)


# ---- sequence- and pipeline-parallel training over 4 gloo processes ----

MESH_WORKER = r'''
import json, sys
from pathlib import Path
import numpy as np
import torch

torch.set_num_threads(1)
import mmmm_tpu_torch.parallel.ring_attention as ring
import mmmm_tpu_torch.parallel.zero as zero
from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, cli, make_optimizer,
                            make_train_step, params_from_jax)
from mmmm_tpu_torch.parallel import PipeLeaf, gather_tree, init_distributed, make_mesh
from mmmm_tpu_torch.parallel.pipeline import set_pipe_context
from mmmm_tpu_torch.parallel.ring_attention import set_ring_context
from mmmm_tpu_torch.params import _unflatten
from mmmm_tpu_torch.peft.lora import flatten, split_trainable
from mmmm_tpu_torch.train.step import TrainState, place_state

tmp, spec = Path(sys.argv[1]), json.loads(sys.argv[2])
assert init_distributed(device="cpu")
rank = torch.distributed.get_rank()
zero.FSDP_MIN_SIZE = spec["fsdp_min"]
cfg, opt = MMMMConfig.tiny(), make_optimizer(OptimizerConfig(**spec["opt"]))
if spec.get("deep"):  # 4 LLM layers, 2 a stage
    import dataclasses
    cfg = dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, num_hidden_layers=4))
lcfg = LoraConfig(**spec["lora"])
saved = dict(np.load(tmp / "state.npz"))
part = lambda prefix: {k[len(prefix):]: v for k, v in saved.items() if k.startswith(prefix)}
mesh = make_mesh(device="cpu", **spec["mesh"])
rings = []  # the ring attentions this process ran (forward, under remat twice)
_fwd_steps = ring._fwd_steps
ring._fwd_steps = lambda *a: rings.append(a[0].shape) or _fwd_steps(*a)
drank, ndata = mesh.get_local_rank("data"), spec["mesh"]["data"]
attn_impl = "pallas"
if spec["mesh"].get("seq", 1) > 1:
    set_ring_context(mesh, "seq")
    attn_impl = "ring"
if spec["mesh"].get("pipe", 1) > 1:
    set_pipe_context(mesh, "pipe", spec["pipe_micro"])


def fresh():
    full = params_from_jax(_unflatten({**part("frozen/"), **part("ft/")}), "cpu", cfg=cfg)
    ft, frozen = split_trainable(full)
    lora = _unflatten({k: torch.tensor(v) for k, v in part("lora/").items()})
    trainable = {"lora": lora, "ft": ft}
    for t in flatten(trainable).values():
        t.requires_grad_(True)
    return TrainState(0, trainable, opt.init(flatten(trainable))), frozen


batch = dict(np.load(tmp / "batch.npz"))
batch.update(patch_size=(4, 4, 4), pool_size=(1, 1, 1))
k = batch["labels"].shape[0] // ndata
local = {n: v[drank * k:(drank + 1) * k] if isinstance(v, np.ndarray) else v
         for n, v in batch.items()}
kw = dict(vg_mode="none", remat=True, dropout_seed=None, vis_span="auto", device="cpu")
s1, f1 = fresh()
s2, f2 = place_state(*fresh(), mesh)
one = make_train_step(cfg, opt, lcfg, attn_impl="pallas", **kw)
meshed = make_train_step(cfg, opt, lcfg, attn_impl=attn_impl, mesh=mesh, **kw)
s1, l1 = one(s1, f1, batch)
s2, l2 = meshed(s2, f2, local)
leaves = flatten(gather_tree(s2.trainable))
result = {"logs_one": {n: float(v) for n, v in l1.items()},
          "logs_mesh": {n: float(v) for n, v in l2.items()},
          "rings": len(rings), "staged": sum(isinstance(v, PipeLeaf) and v.staged
                        for v in flatten(s2.trainable).values()),
          "leaf_err": max(float((leaves[p] - t).detach().abs().max())
                          for p, t in flatten(s1.trainable).items())}
if rank == 0:
    np.savez(tmp / "leaves_mesh.npz", **{p: t.detach().numpy() for p, t in leaves.items()})
if spec.get("unready"):
    # llm_forward under the pipe context where pipe_ready is false (3 rows do
    # not split into 2 microbatches): the stages' layers are gathered, and
    # the forward and the gradient of a staged leaf equal the local route's
    from mmmm_tpu_torch.models.cogvlm.decoder import llm_forward
    from mmmm_tpu_torch.parallel.pipeline import pipe_ready
    from mmmm_tpu_torch.parallel.zero import gather_unstacked, place_tree
    whole = {"cogvlm": {"llm": fresh()[1]["cogvlm"]["llm"]}}
    for t in flatten(whole).values():
        t.requires_grad_(True)
    zero.FSDP_MIN_SIZE = 1 << 30  # staged over pipe, not cut over data
    placed = gather_unstacked(place_tree(whole, mesh))  # as effective_params
    llm, pllm = whole["cogvlm"]["llm"], placed["cogvlm"]["llm"]
    g = torch.Generator().manual_seed(0)
    emb = torch.randn((3, 12, cfg.vlm.hidden_size), generator=g)
    tt = torch.zeros((3, 12), dtype=torch.int32)
    tt[:, 1:5] = 1
    pos = torch.arange(12).repeat(3, 1)
    seg = torch.ones((3, 12), dtype=torch.int32)
    assert not pipe_ready(pllm["layers"], 3) and pipe_ready(pllm["layers"], 4)
    want = llm_forward(llm, cfg.vlm, emb, tt, pos, seg, remat=True)
    got = llm_forward(pllm, cfg.vlm, emb, tt, pos, seg, remat=True)
    leaf = pllm["layers"]["lang_qkv"]
    (gw,) = torch.autograd.grad(want.square().sum(), [llm["layers"]["lang_qkv"]])
    (gg,) = torch.autograd.grad(got.square().sum(), [leaf.local])
    k = gw.shape[0] // 2
    result["unready"] = {"err": float((got - want).detach().abs().max()),
                         "grad_err": float((gg - gw[leaf.first:leaf.first + k]).abs().max()),
                         "staged": bool(leaf.staged)}
if spec["fit"]:
    cli.main(spec["fit"])
(tmp / f"mesh_{rank}.json").write_text(json.dumps(result))
'''


def fit_args(out_dir, datasets: str, extra=()) -> list[str]:
    return ["fit", "-c", str(TINY), "--device", "cpu", "--no-resume",
            f"trainer.out_dir={out_dir}", datasets,
            "data.vl_trans={max_tokens: 64, max_tokens_z: 4}", "trainer.bf16_vlm=false",
            "trainer.frozen_vlm_bf16=false", "trainer.ckpt_every=10", "trainer.max_steps=2",
            "optimizer.max_steps=4", *extra]


def deep(cfg):
    """``cfg`` with a 4-layer LLM (tests/test_pipeline.py's, 2 a stage)."""
    return dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, num_hidden_layers=4))


def jax_state(deep_llm: bool):
    """tests/test_torch_port_train.py ``jax_state0`` (fp32), of the tiny
    model or of its 4-layer-LLM form."""
    if not deep_llm:
        return jax_state0(bf16=False)
    tree = jax.tree.map(jnp.asarray, numpy_params(deep(MMMMConfig.tiny()), 0))
    lora = jlora.lora_init(jax.random.PRNGKey(1), tree, JaxLoraConfig(**LORA))
    ft, frozen = jlora.split_trainable(tree)
    trainable = {"lora": lora, "ft": ft}
    opt = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    return JaxTrainState(jnp.zeros((), jnp.int32), trainable, opt.init(trainable)), frozen


def mesh_runs(tmp, mesh: dict, batch: dict, fit_extra: list, jax_steps, **spec) -> tuple:
    """One launch of 4 gloo processes of :data:`MESH_WORKER` on ``mesh``
    (the step and ``fit``), the JAX references (``jax_steps(state, frozen,
    batch)``) and the one-process fit meanwhile; returns ``(each rank's
    result, the JAX reference, the two fits' metrics)``."""
    state, frozen = jax_state(spec.get("deep", False))
    flat = {f"lora/{p}": np.asarray(v) for p, v in flatten(state.trainable["lora"]).items()}
    flat.update({f"ft/{p}": np.asarray(v) for p, v in flatten(state.trainable["ft"]).items()})
    flat.update({f"frozen/{p}": np.asarray(v) for p, v in flatten(frozen).items()})
    np.savez(tmp / "state.npz", **flat)
    np.savez(tmp / "batch.npz", **{k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
    chip_smoke.write_vl_dataset(tmp / "VLSet", 3, (1, 8, 32, 32), report_chars=120, seed=1)
    datasets = f"data.datasets=[{{name: VLSet, type: vl, dir: {tmp / 'VLSet'}}}]"
    one, many = tmp / "fit_one", tmp / "fit_mesh"
    script = tmp / "mesh_worker.py"
    script.write_text(MESH_WORKER)
    arg = json.dumps({"opt": OPT, "lora": {**LORA, "dropout": 0.0}, "mesh": mesh,
                      "fsdp_min": 1, "fit": fit_args(many, datasets, fit_extra), **spec})
    procs = start_processes(lambda r: [str(script), str(tmp), arg], n=4)
    try:
        ref = jax_steps(state, frozen, {**batch, "patch_size": (4, 4, 4),
                                        "pool_size": (1, 1, 1)})
        cli.main(fit_args(one, datasets))
    finally:
        wait_processes(procs)
    read = lambda d: [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
    port = [json.loads((tmp / f"mesh_{r}.json").read_text()) for r in range(4)]
    return port, ref, (read(one), read(many))


def jax_step_leaves(mesh, state, frozen, batch, attn_impl: str, deep_llm=False) -> dict:
    """One JAX step on ``mesh`` from ``state``: its logs and trainable leaves."""
    step = jax_make_train_step(
        MMMMModel(deep(JaxConfig.tiny()) if deep_llm else JaxConfig.tiny()), jax_make_optimizer(JaxOptimizerConfig(**OPT)),
        JaxLoraConfig(**LORA), vg_mode="none", attn_impl=attn_impl, remat=False, mesh=mesh,
        donate=False, dropout_seed=None, vis_span="auto")
    jstate, logs = step(state, frozen, batch)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "leaves": {p: np.asarray(v) for p, v in
                       flatten(jax.device_get(jstate.trainable)).items()}}


def check_mesh_runs(tmp, port, ref, fits, rings: int = 0):
    """The meshed step against the one-process step and JAX's meshed step
    (loss 1e-4 relative, leaves 2e-5), every rank's logs alike, each rank's
    ring attentions ``rings``, and the meshed fit against the one-process
    fit (1e-5)."""
    assert all(r["logs_mesh"] == port[0]["logs_mesh"] for r in port)
    assert [r["rings"] for r in port] == [rings] * 4
    got = port[0]["logs_mesh"]
    for want in (port[0]["logs_one"], ref["logs"]):
        np.testing.assert_allclose(got["lm_loss"], want["lm_loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert max(r["leaf_err"] for r in port) <= 2e-5
    leaves = np.load(tmp / "leaves_mesh.npz")
    assert set(leaves.files) == set(ref["leaves"])
    for p in leaves.files:
        np.testing.assert_allclose(leaves[p], ref["leaves"][p], rtol=0, atol=2e-5, err_msg=p)
    one, many = fits
    assert [m["step"] for m in many] == [1, 2] == [m["step"] for m in one]
    for a, b in zip(one, many):
        for key in a:
            if key != "steps_per_sec":
                np.testing.assert_allclose(b[key], a[key], rtol=1e-5, err_msg=f"{a['step']} {key}")


def _jax_ring_steps(state, frozen, batch):
    from mmmm_tpu.ops.attention import set_ring_context as jax_set_ring_context

    mesh = jax_make_mesh(data=2, model=1, seq=2)
    jax_set_ring_context(mesh, "seq", "data")
    try:
        return jax_step_leaves(mesh, state, frozen, batch, "ring")
    finally:
        jax_set_ring_context(None)


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_mesh")
    batch = train_batch("none")  # S = 32: the LLM rings; the ViT's 17 tokens do not
    return tmp, *mesh_runs(tmp, {"data": 2, "seq": 2}, batch, ["trainer.mesh_seq=2"],
                           _jax_ring_steps)


def test_seq_step_matches_jax_ring_step_and_one_process(seq_runs):
    tmp, port, ref, fits = seq_runs
    # the tiny LLM's 2 layers ring, twice each under remat; the ViT does not
    check_mesh_runs(tmp, port, ref, fits, rings=2 * 2)
