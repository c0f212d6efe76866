"""The port's ``parallel/`` (the mesh, the sharding rules, the multi-process
runtime, ZeRO-3 over ``data``, the desync checks) and its data-parallel
training against the JAX package's, on the CPU.

  - The rules: ``param_shardings`` and ``fsdp_shardings`` give the JAX
    package's ``PartitionSpec`` for every leaf (parameters, LoRA factors,
    W8A16 ``q``/``s`` leaves) of the tiny tree and of the flagship's shapes
    (meta tensors against ``jax.ShapeDtypeStruct``s; nothing materialized)
    on the 8-CPU-device meshes (data, model, pipe) in (2, 4, 1), (8, 1, 1),
    (1, 8, 1), (2, 2, 2), and ``bytes_per_device`` is equal.
  - The step: ``make_train_step(mesh=make_mesh(data=2))`` in 2 gloo
    processes, the state placed by ``place_state`` with ZeRO's
    ``FSDP_MIN_SIZE`` lowered to 1 so that leaves really shard, over a
    global batch whose two rows hold different numbers of labelled tokens
    (and valid targets), 3 steps in each ``vg_mode``, against JAX's
    ``make_train_step(mesh=make_mesh(data=2, model=1))`` on the same global
    batch: each step's loss within 1e-4 relative and gradient norm within
    1e-5 relative; after the first step from the shared state, the
    gradients through Adam's mu (gathered from the shards) and the
    parameters as tests/test_torch_port_train.py holds the one-process
    step (``assert_update_close``). Its trainable tree after 3 steps
    against the port's one-process step on the global batch within 1e-5
    (the same arithmetic, summed in another order); against JAX's within
    2 * lr, as the one-process step is held (Adam moves a leaf whose
    gradient is zero in exact arithmetic by about lr, either way, on its
    rounding noise).
  - ``fit`` with ``trainer.mesh_data=2`` in 2 processes (the ``fit``
    command, the three variables, gloo) against one process: every line of
    ``metrics.jsonl`` within 1e-5, written once (rank 0), the step-2
    checkpoint's whole tensors equal within 1e-5, and the 2-process
    checkpoint resumed in one process to step 4 gives what the one-process
    checkpoint resumed gives. LoRA dropout is on (conf/tiny/fit.yaml's
    0.05): every process draws the same masks.
  - ``CheckpointManager`` over 2 processes whose directories are not
    shared: rank 0 alone reads and writes, and every process decides alike
    and restores rank 0's checkpoint.
  - ``check_batch_uniform`` and ``assert_replicated_equal`` raise on an
    uneven batch and a perturbed replica; ``init_distributed`` without its
    variables makes no group; the sequence and pipeline axes make a step
    (they run in tests/test_torch_port_ring.py and
    tests/test_torch_port_pipeline.py), and pipeline with tensor
    parallelism raises (the tensor axis runs:
    tests/test_torch_port_tensor_parallel.py).

Each multi-process case spawns 2 processes with ``OMP_NUM_THREADS=1`` and a
timeout of its own, around a rendezvous store that this process serves.
"""
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed import TCPStore

import chip_smoke
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import MMMMModel
from mmmm_tpu.parallel import make_mesh as jax_make_mesh
from mmmm_tpu.parallel import sharding as jsharding
from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.train import OptimizerConfig as JaxOptimizerConfig
from mmmm_tpu.train import make_optimizer as jax_make_optimizer
from mmmm_tpu.train import make_train_step as jax_make_train_step
from mmmm_tpu_torch import MMMMConfig, cli
from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.ops.attention import segment_attention
from mmmm_tpu_torch.parallel import init_distributed, make_mesh
from mmmm_tpu_torch.parallel import sharding as psharding
from mmmm_tpu_torch.params import _QUANTIZABLE, param_spec
from mmmm_tpu_torch.peft.lora import default_lora_targets, flatten, unflatten
from mmmm_tpu_torch.train.checkpoint import CheckpointManager
from test_data_pipeline import _make_box_case, _make_seg_case
from test_torch_port_train import (LORA, LR, OPT, STEPS, assert_update_close, jax_state0,
                                   train_batch)

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"
TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the in-process runs' tiny tensors (the suite
    runs six workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the rules, leaf by leaf ----

def _shape_tree(cfg, lora_r: int, int8: bool, bf16: bool) -> dict:
    """The parameter tree's shapes (the W8A16 leaves as ``{"q", "s"}`` with
    ``int8``) and its LoRA factors, as ``(shape, dtype name)`` leaves."""
    flat = {}
    for path, leaf in flatten(param_spec(cfg)).items():
        dt = "float32" if leaf.fp32 or not bf16 else "bfloat16"
        if int8 and path in _QUANTIZABLE:
            flat[f"{path}/q"] = (leaf.shape, "int8")
            flat[f"{path}/s"] = ((*leaf.shape[:-2], 1, leaf.shape[-1]), dt)
        else:
            flat[path] = (leaf.shape, dt)
    meta = {p: torch.empty(s, device="meta") for p, (s, _) in flat.items()}
    for t in default_lora_targets(meta):
        *lead, fan_in, fan_out = flat[t][0]
        flat[f"lora/{t}/a"] = ((*lead, fan_in, lora_r), "float32")
        flat[f"lora/{t}/b"] = ((*lead, lora_r, fan_out), "float32")
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


MESHES = [(2, 4, 1), (8, 1, 1), (1, 8, 1), (2, 2, 2)]  # (data, model, pipe)
FLAGSHIP = MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())


@pytest.mark.parametrize("dmp", MESHES, ids=lambda m: "data%d-model%d-pipe%d" % m)
@pytest.mark.parametrize("case", ["tiny", "tiny-w8a16", "flagship", "flagship-w8a16"])
def test_rules_match_jax_specs(case, dmp):
    data, model, pipe = dmp
    cfg = MMMMConfig.tiny() if case.startswith("tiny") else FLAGSHIP
    shapes = _shape_tree(cfg, 4 if case.startswith("tiny") else 64, case.endswith("w8a16"),
                         bf16=case.startswith("flagship"))
    jtree = _map(lambda s: jax.ShapeDtypeStruct(s[0], jnp.dtype(s[1])), shapes)
    ptree = _map(lambda s: torch.empty(s[0], dtype=getattr(torch, s[1]), device="meta"),
                 shapes)
    jmesh = jax_make_mesh(data=data, model=model, pipe=pipe)
    sizes = dict(jmesh.shape)
    assert list(jmesh.axis_names) == (["pipe"] if pipe > 1 else []) + ["data", "model"]
    checked = 0
    for min_size in ((1, 1 << 16) if case.startswith("tiny") else (1 << 16,)):
        for name, jfn, pfn in (
                ("param", jsharding.param_shardings, psharding.param_shardings),
                ("fsdp", lambda t, m: jsharding.fsdp_shardings(t, m, min_size=min_size),
                 lambda t, m: psharding.fsdp_shardings(t, m, min_size=min_size))):
            jspec = {p: tuple(s.spec) for p, s in flatten(jfn(jtree, jmesh)).items()}
            pspec = flatten(pfn(ptree, sizes))
            assert set(pspec) == set(jspec)
            bad = {p: (pspec[p], jspec[p]) for p in jspec if pspec[p] != jspec[p]}
            assert not bad, f"{name} min_size {min_size}: {dict(list(bad.items())[:5])}"
            if name == "fsdp" and min_size == 1:
                assert any("data" in s for s in pspec.values()) or data == 1
            jbytes = jsharding.bytes_per_device(jtree, jfn(jtree, jmesh))
            assert psharding.bytes_per_device(ptree, pfn(ptree, sizes), sizes) == jbytes
            checked += len(pspec)
    assert checked > 0


# ---- processes ----

def start_processes(argv_of_rank, n: int = 2, cwd=None) -> list:
    """Start ``n`` processes of ``argv_of_rank(rank)`` joined by the three
    variables (gloo over loopback). Their rendezvous store is served from
    this process, on a port the system picks as it binds it, and lives until
    the processes are done (it rides on the first one): no port is handed
    out between a probe and its use, and no rank's exit takes the store
    from the others (torch's agent-store mode: every rank is a client)."""
    store = TCPStore("127.0.0.1", 0, n, is_master=True, wait_for_workers=False,
                     timeout=timedelta(seconds=TIMEOUT_S))
    procs = []
    for rank in range(n):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                   COORDINATOR_ADDRESS=f"127.0.0.1:{store.port}", NUM_PROCESSES=str(n),
                   PROCESS_ID=str(rank), TORCHELASTIC_USE_AGENT_STORE="True")
        procs.append(subprocess.Popen([sys.executable, *argv_of_rank(rank)], env=env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    procs[0].store = store
    return procs


def wait_processes(procs) -> list[str]:
    """Their standard outputs, once each has exited 0 within ``TIMEOUT_S``;
    any still running is killed."""
    outs, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
            if p.returncode != 0:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errs, errs
    return outs


STEP_WORKER = r'''
import json, sys
from pathlib import Path
import numpy as np
import torch

torch.set_num_threads(1)
import mmmm_tpu_torch.parallel.zero as zero
zero.FSDP_MIN_SIZE = 1  # the tiny model's leaves are all below the default
from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, make_optimizer,
                            make_train_step, params_from_jax)
from mmmm_tpu_torch.parallel import ZeroLeaf, gather_tree, init_distributed, make_mesh
from mmmm_tpu_torch.params import _unflatten
from mmmm_tpu_torch.peft.lora import flatten, split_trainable
from mmmm_tpu_torch.train.step import TrainState, place_state

data, out, spec = Path(sys.argv[1]), Path(sys.argv[2]), json.loads(sys.argv[3])
cfg, opt = MMMMConfig.tiny(), make_optimizer(OptimizerConfig(**spec["opt"]))
lcfg = LoraConfig(**spec["lora"])
saved = dict(np.load(data / "state.npz"))
part = lambda prefix: {k[len(prefix):]: v for k, v in saved.items() if k.startswith(prefix)}
world = int(sys.argv[4])
if world > 1:
    assert init_distributed(device="cpu")
    mesh = make_mesh(data=world, device="cpu")
    rank = mesh.get_local_rank("data")
else:
    mesh, rank = None, 0
result = {}
for mode in spec["modes"]:
    full = params_from_jax(_unflatten({**part("frozen/"), **part("ft/")}), "cpu", cfg=cfg)
    ft, frozen = split_trainable(full)
    lora = _unflatten({k: torch.tensor(v) for k, v in part("lora/").items()})
    trainable = {"lora": lora, "ft": ft}
    for t in flatten(trainable).values():
        t.requires_grad_(True)
    state = TrainState(0, trainable, opt.init(flatten(trainable)))
    if mesh is not None:
        state, frozen = place_state(state, frozen, mesh)
    batch = dict(np.load(data / f"batch_{mode}.npz"))
    k = batch["labels"].shape[0] // world
    batch = {n: v[rank * k:(rank + 1) * k] for n, v in batch.items()}
    batch.update(patch_size=(4, 4, 4), pool_size=(1, 1, 1))
    step = make_train_step(cfg, opt, lcfg, vg_mode=mode, attn_impl="pallas", remat=True,
                           mesh=mesh, dropout_seed=None, vis_span="auto", device="cpu")
    logs = []
    for i in range(spec["steps"]):
        state, log = step(state, frozen, batch)
        logs.append({n: float(v) for n, v in log.items()})
        if i == 0:  # the first update from the shared state, gathered whole
            first = {**{"p/" + p: t for p, t in flatten(gather_tree(state.trainable)).items()},
                     **{"mu/" + p: t for p, t in gather_tree(state.opt_state["mu"]).items()}}
            if rank == 0:
                np.savez(out / f"first_{mode}_{world}.npz",
                         **{p: t.detach().numpy() for p, t in first.items()})
    leaves = flatten(gather_tree(state.trainable))
    result[mode] = {"logs": logs, "tokens": int((batch["labels"] != -100).sum()),
                    "sharded": sum(isinstance(v, ZeroLeaf) for v in flatten(state.trainable).values()),
                    "leaves": len(leaves)}
    if rank == 0:
        np.savez(out / f"leaves_{mode}_{world}.npz",
                 **{p: t.detach().numpy() for p, t in leaves.items()})
(out / f"result_{world}_{rank}.json").write_text(json.dumps(result))
'''

MODES = ("none", "semantic", "instance")


def uneven_batch(mode: str) -> dict:
    """tests/test_torch_port_train.py's batch with the second row's first six
    labelled tokens ignored: the two ranks hold 12 and 6 labelled tokens."""
    batch = train_batch(mode)
    batch["labels"][1, 20:26] = -100
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The 2-process and the one-process port runs (one launch each for the
    three modes) and JAX's data-parallel step on the same global batches."""
    tmp = tmp_path_factory.mktemp("dp_step")
    state, frozen = jax_state0(bf16=False)
    flat = {f"lora/{p}": np.asarray(v) for p, v in flatten(state.trainable["lora"]).items()}
    flat.update({f"ft/{p}": np.asarray(v) for p, v in flatten(state.trainable["ft"]).items()})
    flat.update({f"frozen/{p}": np.asarray(v) for p, v in flatten(frozen).items()})
    np.savez(tmp / "state.npz", **flat)
    for mode in MODES:
        np.savez(tmp / f"batch_{mode}.npz", **uneven_batch(mode))
    script = tmp / "step_worker.py"
    script.write_text(STEP_WORKER)
    spec = json.dumps({"opt": OPT, "lora": {**LORA, "dropout": 0.0}, "modes": MODES,
                       "steps": STEPS})
    # the port's runs go on while JAX compiles its three steps
    procs = start_processes(lambda r: [str(script), str(tmp), str(tmp), spec, "2"])
    procs += start_processes(lambda r: [str(script), str(tmp), str(tmp), spec, "1"], n=1)
    try:
        ref = jax_runs(state, frozen)
    finally:
        wait_processes(procs)
    read = lambda name: json.loads((tmp / name).read_text())
    port = {"two": [read("result_2_0.json"), read("result_2_1.json")],
            "one": read("result_1_0.json")}
    return tmp, port, ref


def jax_runs(state0, frozen) -> dict:
    """Three steps of JAX's data-parallel step (data 2) in each mode, each
    from ``state0`` (not donated)."""
    jmesh = jax_make_mesh(data=2, model=1)
    ref = {}
    for mode in MODES:
        step = jax_make_train_step(
            MMMMModel(JaxConfig.tiny()), jax_make_optimizer(JaxOptimizerConfig(**OPT)),
            JaxLoraConfig(**LORA), vg_mode=mode, attn_impl="xla", remat=True, mesh=jmesh,
            donate=False, dropout_seed=None, vis_span="auto")
        jstate = state0
        batch = {**uneven_batch(mode), "patch_size": (4, 4, 4), "pool_size": (1, 1, 1)}
        logs = []
        for i in range(STEPS):
            jstate, log = step(jstate, frozen, batch)
            logs.append({k: float(v) for k, v in log.items()})
            if i == 0:
                first = jax.device_get(jstate)
        ref[mode] = {"logs": logs, "first": first, "leaves": {
            p: np.asarray(v) for p, v in flatten(jax.device_get(jstate.trainable)).items()}}
    return ref


@pytest.mark.parametrize("mode", MODES)
def test_two_process_step_matches_jax_data_parallel_step(step_runs, mode):
    tmp, port, ref = step_runs
    r0, r1 = (p[mode] for p in port["two"])
    assert r0["logs"] == r1["logs"]  # every process holds the global batch's logs
    assert r0["tokens"] != r1["tokens"]
    assert 0 < r0["sharded"] <= r0["leaves"] and r0["sharded"] > r0["leaves"] // 2
    for i, (got, want) in enumerate(zip(r0["logs"], ref[mode]["logs"])):
        assert set(got) == set(want)
        for key in want:
            tol = 1e-5 if key == "grad_norm" else 1e-4
            np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                       err_msg=f"{mode} step {i + 1} {key}")
    two = np.load(tmp / f"leaves_{mode}_2.npz")
    one = np.load(tmp / f"leaves_{mode}_1.npz")
    assert set(two.files) == set(one.files) == set(ref[mode]["leaves"])
    for p in two.files:
        np.testing.assert_allclose(two[p], one[p], rtol=0, atol=1e-5, err_msg=p)
        np.testing.assert_allclose(two[p], ref[mode]["leaves"][p], rtol=0, atol=2 * LR,
                                   err_msg=p)
    for got, want in zip(r0["logs"], port["one"][mode]["logs"]):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    # the first step's gradients (the reduce-scatters, the replicated leaves'
    # all-reduce, the global counts) through Adam's mu, against JAX's
    first = np.load(tmp / f"first_{mode}_2.npz")
    part = lambda prefix: {p[len(prefix):]: torch.from_numpy(first[p]) for p in first.files
                           if p.startswith(prefix)}
    got = SimpleNamespace(trainable=unflatten(part("p/")), opt_state={"mu": part("mu/")})
    assert set(got.opt_state["mu"]) == set(flatten(got.trainable)) == set(two.files)
    assert_update_close(got, ref[mode]["first"], r0["logs"][0], ref[mode]["logs"][0], 1)


# ---- fit over two processes ----

# the fit command with ZeRO's threshold lowered to 1, so that the tiny
# model's leaves shard
FIT_EVERY_LEAF_SHARDED = ("import sys, mmmm_tpu_torch.parallel.zero as z; z.FSDP_MIN_SIZE = 1; "
                          "from mmmm_tpu_torch import cli; cli.main(sys.argv[1:])")


def _fit_args(out_dir, datasets: str, max_steps: int, extra=(), resume=True) -> list[str]:
    return ["fit", "-c", str(TINY), "--device", "cpu", *([] if resume else ["--no-resume"]),
            f"trainer.out_dir={out_dir}",
            datasets, "data.vl_trans={max_tokens: 64, max_tokens_z: 4}",
            "trainer.bf16_vlm=false", "trainer.frozen_vlm_bf16=false", "trainer.ckpt_every=2",
            f"trainer.max_steps={max_steps}", "optimizer.max_steps=4", *extra]


def _metrics(d: Path) -> list:
    return [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]


def test_fit_two_processes_matches_one_and_resumes_in_one(tmp_path):
    root = tmp_path / "data"
    for i in range(3):
        _make_seg_case(root / "SegSet", f"case{i}", rng=np.random.default_rng(i))
    for i in range(2):
        _make_box_case(root / "BoxSet", f"case{i}")
    chip_smoke.write_vl_dataset(root / "VLSet", 3, (1, 8, 32, 32), report_chars=120, seed=1)
    types = {"SegSet": "local", "BoxSet": "local", "VLSet": "vl"}
    datasets = "data.datasets=[" + ", ".join(
        f"{{name: {k}, type: {v}, dir: {root / k}}}" for k, v in types.items()) + "]"
    one, two = tmp_path / "one", tmp_path / "two"
    procs = start_processes(lambda r: ["-c", FIT_EVERY_LEAF_SHARDED, *_fit_args(
        two, datasets, 2, ["trainer.mesh_data=2"], resume=False)], cwd=ROOT)
    try:
        cli.main(_fit_args(one, datasets, 2, resume=False))
    finally:
        wait_processes(procs)
    assert (two / "adapter.npz").exists()
    m1, m2 = _metrics(one), _metrics(two)
    assert [m["step"] for m in m2] == [1, 2]  # one line a step: rank 0 alone writes
    for a, b in zip(m1, m2):
        assert set(a) == set(b)
        for k in a:
            if k != "steps_per_sec":
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=f"{a['step']} {k}")
    for name in ("trainable", "opt_state"):
        a = flatten(torch.load(one / "ckpt" / "2" / f"{name}.pt", weights_only=True))
        b = flatten(torch.load(two / "ckpt" / "2" / f"{name}.pt", weights_only=True))
        assert set(a) == set(b)
        for p in a:
            if isinstance(a[p], torch.Tensor):
                assert a[p].shape == b[p].shape, p
                torch.testing.assert_close(b[p], a[p], rtol=0, atol=1e-5, msg=p)
            else:
                assert a[p] == b[p], p
    # each checkpoint resumed in one process to step 4
    cli.main(_fit_args(one, datasets, 4))
    cli.main(_fit_args(two, datasets, 4))
    m1, m2 = _metrics(one), _metrics(two)
    assert [m["step"] for m in m2] == [1, 2, 3, 4] == [m["step"] for m in m1]
    for a, b in zip(m1[2:], m2[2:]):
        for k in a:
            if k != "steps_per_sec":
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=f"{a['step']} {k}")


# ---- checkpoints over processes that share no directory ----

CKPT_WORKER = r'''
import json, sys
from pathlib import Path
import torch
from mmmm_tpu_torch.parallel import init_distributed, make_mesh
from mmmm_tpu_torch.train.checkpoint import CheckpointManager

assert init_distributed(device="cpu")
group = make_mesh(data=2, device="cpu").get_group("data")
rank = torch.distributed.get_rank(group)
m = CheckpointManager(Path(sys.argv[1]) / f"rank{rank}", 2, keep=2, group=group)
seen = {"steps": m.all_steps()}
step, got = m.restore({"trainable": {"w": torch.zeros(3)}, "opt_state": {"count": 0}})
seen.update(step=step, w=got["trainable"]["w"].tolist(), count=got["opt_state"]["count"])
state = {"trainable": {"w": torch.full((3,), float(rank))}, "opt_state": {"count": 6}}
seen["saved"] = [m.maybe_save(s, state) for s in (5, 6)]
m.force_save(7, lambda: state)
seen["after"] = m.all_steps()
try:
    m.restore({"trainable": {"w": torch.zeros(4)}, "opt_state": {"count": 0}})
except ValueError as e:
    seen["error"] = str(e)
print(json.dumps(seen))
'''


def test_checkpoints_over_unshared_directories(tmp_path):
    """Each process gets a directory of its own, and only rank 0's holds a
    checkpoint (step 4): both processes see rank 0's steps, restore its
    tensors, save at the same steps and keep the same ones, and a mismatched
    tree raises on both; rank 1's directory is never made."""
    w = torch.arange(3.0)
    assert CheckpointManager(tmp_path / "rank0", 2).maybe_save(
        4, {"trainable": {"w": w}, "opt_state": {"count": 4}})
    script = tmp_path / "ckpt_worker.py"
    script.write_text(CKPT_WORKER)
    outs = wait_processes(start_processes(lambda r: [str(script), str(tmp_path)]))
    seen = [json.loads(out.splitlines()[-1]) for out in outs]
    assert seen[0] == seen[1]
    assert seen[0]["steps"] == [4] and seen[0]["step"] == 4 and seen[0]["count"] == 4
    assert seen[0]["w"] == w.tolist() and seen[0]["saved"] == [False, True]
    assert seen[0]["after"] == [6, 7] and "does not match" in seen[0]["error"]
    assert sorted(p.name for p in (tmp_path / "rank0").iterdir()) == ["6", "7"]
    assert not (tmp_path / "rank1").exists()
    got = torch.load(tmp_path / "rank0" / "7" / "trainable.pt", weights_only=True)
    assert torch.equal(got["w"], torch.zeros(3))  # rank 0's tree


# ---- the desync checks, init_distributed, the axes that wait ----

DEBUG_WORKER = r'''
import sys
import torch
from mmmm_tpu_torch.parallel import (assert_replicated_equal, check_batch_uniform,
                                     init_distributed, make_mesh)

assert init_distributed(device="cpu")
mesh = make_mesh(data=2, device="cpu")
rank = mesh.get_local_rank("data")
check_batch_uniform({"x": torch.zeros(2, 3), "n": torch.zeros(())}, mesh, world_size=2)
try:
    check_batch_uniform({"x": torch.zeros(3, 3)}, mesh)
except ValueError as e:
    print("odd:", e)
else:
    raise SystemExit("an odd global batch passed")
try:
    check_batch_uniform({"x": torch.zeros(2 + rank, 3)}, mesh, world_size=2)
except ValueError as e:
    print("uneven:", e)
else:
    raise SystemExit("an uneven batch passed")
tree = {"w": torch.arange(6.0).reshape(2, 3), "step": torch.tensor(3)}
assert_replicated_equal(tree, mesh)
if rank == 1:
    tree["w"] = tree["w"] + 1e-3
assert_replicated_equal(tree, mesh, atol=1e-2)
try:
    assert_replicated_equal(tree, mesh)
except AssertionError as e:
    print("diverged:", e)
else:
    raise SystemExit("a perturbed replica passed")
'''


def test_desync_checks_raise(tmp_path):
    script = tmp_path / "debug_worker.py"
    script.write_text(DEBUG_WORKER)
    outs = wait_processes(start_processes(lambda r: [str(script)]))
    for out in outs:
        assert "odd: batch[x]: global leading dim 3 not divisible by data=2" in out
        assert "uneven: batch leading dims differ" in out
        assert "diverged: w: replicated value diverges between rank 0 and rank 1" in out


def test_init_distributed_without_variables_makes_no_group(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="PROCESS_ID"):
        init_distributed("127.0.0.1:1", 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(data=1)


def test_tensor_sequence_pipeline_axes_name_their_roadmap_items():
    """The sequence and pipeline axes make a step (they run over processes
    in tests/test_torch_port_ring.py and tests/test_torch_port_pipeline.py);
    the model axis runs (tests/test_torch_port_tensor_parallel.py), and with
    a pipeline axis it raises, in the step and in the pipe context, as the
    reference's pipeline does. ``impl="ring"`` without a ring context is
    ``"auto"``."""
    from mmmm_tpu_torch import LoraConfig, OptimizerConfig, make_optimizer, make_train_step
    from mmmm_tpu_torch.parallel.pipeline import set_pipe_context

    def mesh(**sizes):  # the parts of a DeviceMesh that make_train_step reads
        return SimpleNamespace(mesh_dim_names=tuple(sizes), mesh=torch.zeros(*sizes.values()),
                               device_type="cpu", get_group=lambda axis: None,
                               size=lambda i: list(sizes.values())[i])

    opt = make_optimizer(OptimizerConfig())
    for sizes in ({"data": 1, "model": 1, "seq": 2}, {"pipe": 2, "data": 1, "model": 1}):
        assert callable(make_train_step(MMMMConfig.tiny(), opt, LoraConfig(),
                                        mesh=mesh(**sizes), device="cpu"))
    with pytest.raises(ValueError, match="model>1 XOR pipe>1"):
        make_train_step(MMMMConfig.tiny(), opt, LoraConfig(),
                        mesh={"pipe": 2, "data": 1, "model": 2}, device="cpu")
    with pytest.raises(ValueError, match="model>1 XOR pipe>1"):
        set_pipe_context(mesh(pipe=2, data=1, model=2))
    q = torch.randn((1, 4, 2, 8), generator=torch.Generator().manual_seed(0))
    seg = torch.ones((1, 4), dtype=torch.int32)
    torch.testing.assert_close(segment_attention(q, q, q, seg, impl="ring"),
                               segment_attention(q, q, q, seg, impl="auto"), rtol=0, atol=0)
