"""The port's training loop (``train/trainer.py Trainer``, ``TrainerConfig``,
``train/checkpoint.py CheckpointManager``, ``python -m mmmm_tpu_torch.cli
fit``) against the JAX package's, on the CPU.

Trainer parity: conf/tiny/fit.yaml with ``bf16_vlm`` and
``frozen_vlm_bf16`` off and ``lora.dropout`` 0 (the packages draw
different dropout masks), 4 steps over seg + box + vl data (one step of
each grounding mode at least), the port's ``fit`` started from the state of
JAX's ``init_train_state(PRNGKey(seed))`` bridged by ``train_state_from_jax``:
every line of ``metrics.jsonl`` has the JAX ``Trainer.fit``'s keys and
values within 1e-4 relative (``steps_per_sec`` aside), and ``adapter.npz``,
read by the JAX package's ``load_adapter``, matches JAX's leaf for leaf
within 1e-4 of the leaf's largest magnitude plus 2 * lr (Adam moves a
coordinate by about lr whatever its gradient's size, so a near-zero
gradient whose sign differs in fp32 moves it the other way;
tests/test_torch_port_train.py). Measured on this CPU: the metrics within
2.5e-7 relative; the adapter within 8e-5 absolute, 17 of its 249 leaves
past 1e-4 of their largest (SAM's attention weights and the key biases,
whose gradients are zero in exact arithmetic).

``CheckpointManager`` saves at the steps orbax's manager (the JAX
package's) saves at, over (start, ``save_every``, ``keep``) cases, and
restores a state bit for bit. The ``fit`` command runs end to end, resumes,
and turns SIGTERM into a checkpoint at the next step boundary; every
shipped config builds into the port's ``TrainerConfig``.
"""
import json
import os
import signal
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mmmm_tpu import build as jbuild
from mmmm_tpu.config import build as jax_build_cfg
from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.train import OptimizerConfig as JaxOptimizerConfig
from mmmm_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from mmmm_tpu.train.checkpoint import load_adapter as jax_load_adapter
from mmmm_tpu.train.step import init_train_state as jax_init_train_state
from mmmm_tpu.train.trainer import Trainer as JaxTrainer
from mmmm_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from mmmm_tpu_torch import cli, train_state_from_jax
from mmmm_tpu_torch.build import build_dataset, build_model, build_tokenizer
from mmmm_tpu_torch.config import apply_overrides, build, load_yaml, resolve_interpolations
from mmmm_tpu_torch.data.local import DatasetConf
from mmmm_tpu_torch.models.mmmm import MMMMConfig
from mmmm_tpu_torch.ops.attention import kernel_head_dim
from mmmm_tpu_torch.peft import LoraConfig
from mmmm_tpu_torch.peft.lora import flatten
from mmmm_tpu_torch.train import OptimizerConfig
from mmmm_tpu_torch.train.checkpoint import CheckpointManager
from mmmm_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_data_pipeline import _make_box_case, _make_seg_case

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"


@pytest.fixture(scope="module")
def fit_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    for i in range(3):
        _make_seg_case(root / "SegSet", f"case{i}", rng=np.random.default_rng(i))
    for i in range(2):
        _make_box_case(root / "BoxSet", f"case{i}")
    chip_smoke.write_vl_dataset(root / "VLSet", 3, (1, 8, 32, 32), report_chars=120, seed=1)
    return root


def _datasets(root, kinds=("SegSet", "BoxSet", "VLSet")) -> str:
    types = {"SegSet": "local", "BoxSet": "local", "VLSet": "vl"}
    return "data.datasets=[" + ", ".join(
        f"{{name: {k}, type: {types[k]}, dir: {root / k}}}" for k in kinds) + "]"


def _fit_config(overrides: list[str]) -> dict:
    cfg = apply_overrides(load_yaml(TINY, resolve=False), overrides)
    return resolve_interpolations(cfg)


def test_trainer_matches_jax(fit_data, tmp_path, monkeypatch):
    cfg = _fit_config([
        "trainer.bf16_vlm=false", "trainer.frozen_vlm_bf16=false", "lora.dropout=0",
        "trainer.ckpt_every=2", "data.vl_trans={max_tokens: 64, max_tokens_z: 4}",
        _datasets(fit_data)])
    # one JAX device, so that its Trainer makes no mesh (nor does the port's in one process)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    jtok = jbuild.build_tokenizer(cfg["tokenizer"])
    jmodel = jbuild.build_model(cfg["model"], jtok)
    jcfg = jax_build_cfg(JaxTrainerConfig, {**cfg["trainer"], "out_dir": str(tmp_path / "jax")})
    jtrainer = JaxTrainer(jmodel, jbuild.build_dataset(cfg["data"], jtok, TINY.parent),
                          jax_build_cfg(JaxOptimizerConfig, cfg["optimizer"]),
                          jax_build_cfg(JaxLoraConfig, cfg["lora"]), jcfg)
    jstate, jfrozen = jax_init_train_state(jax.random.PRNGKey(jcfg.seed), jmodel,
                                           jtrainer.optimizer, jtrainer.lora_cfg)
    jtrainer.fit(resume=False)

    tok = build_tokenizer(cfg["tokenizer"])
    model = build_model(cfg["model"], tok)
    pcfg = build(TrainerConfig, {**cfg["trainer"], "out_dir": str(tmp_path / "port")})
    trainer = Trainer(model, build_dataset(cfg["data"], tok, TINY.parent),
                      build(OptimizerConfig, cfg["optimizer"]), build(LoraConfig, cfg["lora"]),
                      pcfg, device="cpu")
    modes = []
    for mode, step in list(trainer.steps.items()):
        trainer.steps[mode] = lambda s, f, b, _step=step, _mode=mode: (modes.append(_mode),
                                                                     _step(s, f, b))[1]
    start = train_state_from_jax(jax.device_get(jstate), jax.device_get(jfrozen), "cpu",
                                 cfg=model.cfg)
    trainer.fit(resume=False, state=start)

    assert set(modes) == {"none", "semantic", "instance"}, modes
    read = lambda d: [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
    got, want = read(tmp_path / "port"), read(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            if k not in ("step", "steps_per_sec"):
                assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (g["step"], k, g[k], w[k])
    assert sorted(p.name for p in (tmp_path / "port" / "ckpt").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax" / "ckpt").iterdir() if p.name.isdigit())
    mine = flatten(jax_load_adapter(tmp_path / "port" / "adapter.npz"))
    ref = flatten(jax_load_adapter(tmp_path / "jax" / "adapter.npz"))
    assert set(mine) == set(ref)
    lr = cfg["optimizer"]["lr"]
    for p, r in ref.items():
        assert mine[p].dtype == r.dtype and mine[p].shape == r.shape, p
        err = np.abs(mine[p] - r).max()
        assert err <= 1e-4 * np.abs(r).max() + 2 * lr, (p, err, np.abs(r).max())


def test_fit_cli_end_to_end_and_resume(fit_data, tmp_path):
    """4 steps over seg + box data on the CPU: metrics, the adapter, the
    checkpoints of orbax's policy (steps 1 and 4); then a resumed run to 5."""
    out = tmp_path / "run"
    cli.main(["fit", "-c", str(TINY), "--no-resume", "--device", "cpu",
              f"trainer.out_dir={out}", _datasets(fit_data, ("SegSet", "BoxSet"))])
    metrics = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [1, 2, 3, 4]
    assert np.isfinite(metrics[-1]["lm_loss"])
    assert (out / "adapter.npz").exists()
    assert sorted(int(p.name) for p in (out / "ckpt").iterdir()) == [1, 4]
    cli.main(["fit", "-c", str(TINY), "--device", "cpu", f"trainer.out_dir={out}",
              "trainer.max_steps=5", _datasets(fit_data, ("SegSet",))])
    metrics = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [1, 2, 3, 4, 5]


def test_preemption_checkpoint(fit_data, tmp_path):
    """SIGTERM after the first logged step: a checkpoint at the next step
    boundary, and the run stops there (``max_steps`` 40 ends the test if
    the signal were missed)."""
    out = tmp_path / "run"
    stop = threading.Event()

    def fire_after_first_step():
        metrics = out / "metrics.jsonl"
        while not stop.is_set():
            if metrics.exists() and metrics.read_text().strip():
                os.kill(os.getpid(), signal.SIGTERM)
                return
            stop.wait(0.05)

    watcher = threading.Thread(target=fire_after_first_step, daemon=True)
    watcher.start()
    try:
        cli.main(["fit", "-c", str(TINY), "--no-resume", "--device", "cpu",
                  f"trainer.out_dir={out}", "trainer.max_steps=40", "trainer.ckpt_every=1000",
                  "trainer.log_every=1", _datasets(fit_data, ("SegSet",))])
    finally:
        stop.set()
        watcher.join(timeout=10)
    assert not watcher.is_alive()
    steps = sorted(int(p.name) for p in (out / "ckpt").iterdir())
    logged = [json.loads(x)["step"] for x in (out / "metrics.jsonl").read_text().splitlines()]
    # step 1 by the first-step rule; the run stopped at the step boundary
    # after the signal with that step on disk
    assert steps[0] == 1 and steps[-1] == logged[-1] < 40 and len(steps) <= 2


@pytest.mark.parametrize("start,stop,save_every,keep", [
    (1, 9, 4, None), (3, 6, 4, None), (1, 9, 4, 2), (5, 11, 2, 1), (1, 5, 1, 3)])
def test_checkpoint_steps_match_orbax(tmp_path, start, stop, save_every, keep):
    """The steps on disk after each save, then after a second manager over
    the same directory continues to ``stop + 3`` with a forced save."""
    state = {"trainable": {"w": np.arange(4, dtype=np.float32)},
             "opt_state": {"count": np.asarray(0)}}
    tensors = {"trainable": {"w": torch.arange(4, dtype=torch.float32)}, "opt_state": {"count": 0}}
    seen = {"jax": [], "port": []}
    for run in range(2):
        first, last = (start, stop) if run == 0 else (stop + 1, stop + 3)
        jm = JaxCheckpointManager(tmp_path / "jax", save_every, keep)
        pm = CheckpointManager(tmp_path / "port", save_every, keep)
        for step in range(first, last + 1):
            saved = (jm.maybe_save(step, state), pm.maybe_save(step, tensors))
            assert saved[0] == saved[1], (step, saved)
            jm.wait()
            seen["jax"].append(list(jm.manager.all_steps()))
            seen["port"].append(pm.all_steps())
        jm.force_save(last, state)
        pm.force_save(last, tensors)
        jm.wait()
        assert sorted(jm.manager.all_steps()) == pm.all_steps() and pm.latest_step() == last
    assert [sorted(s) for s in seen["jax"]] == seen["port"]


def test_checkpoint_restores_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    state = {"trainable": {"lora": {"a": torch.randn(3, 4, generator=gen)},
                           "ft": {"w": torch.randn(5, generator=gen).to(torch.bfloat16)}},
             "opt_state": {"count": 7, "mu": {"lora/a": torch.randn(3, 4, generator=gen)}}}
    m = CheckpointManager(tmp_path, 7)
    assert m.restore(state) == (None, None)
    assert m.maybe_save(7, state) and not m.maybe_save(7, state)
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())
    like = {"trainable": {"lora": {"a": torch.zeros(3, 4)},
                          "ft": {"w": torch.zeros(5, dtype=torch.bfloat16)}},
            "opt_state": {"count": 0, "mu": {"lora/a": torch.zeros(3, 4)}}}
    step, got = CheckpointManager(tmp_path, 7).restore(like)
    assert step == 7 and got["opt_state"]["count"] == 7
    for p, t in flatten(state).items():
        if isinstance(t, torch.Tensor):
            assert flatten(got)[p].dtype == t.dtype and torch.equal(flatten(got)[p], t), p
    with pytest.raises(ValueError, match="does not match"):
        CheckpointManager(tmp_path, 7).restore({"trainable": {}, "opt_state": {}})


def _shipped_configs():
    conf = ROOT / "conf"
    return sorted([*conf.glob("phase-*/fit.yaml"), conf / "tiny" / "fit.yaml",
                   *conf.glob("align-*/fit.yaml"), *conf.glob("finetune/*.yaml")])


@pytest.mark.parametrize("path", _shipped_configs(), ids=lambda p: str(p.relative_to(ROOT)))
def test_shipped_config_builds(path):
    """Every shipped config's trainer (and optimizer, LoRA, model and data
    ``conf`` sections where it has them) builds into the port's classes."""
    cfg = load_yaml(path)
    tcfg = build(TrainerConfig, cfg["trainer"])
    assert tcfg.attn_impl == "pallas" and tcfg.max_steps == cfg["trainer"]["max_steps"]
    build(OptimizerConfig, cfg.get("optimizer") or {})
    if "lora" in cfg:
        build(LoraConfig, cfg["lora"])
    if "vlm" in (cfg.get("model") or {}):
        build(MMMMConfig, cfg["model"])
    if isinstance(cfg.get("data"), dict) and "conf" in cfg["data"]:
        build(DatasetConf, cfg["data"]["conf"])


@pytest.mark.parametrize("key,value", [("mesh_model", 4), ("mesh_seq", 2), ("mesh_pipe", 2),
                                       ("mesh_data", 2)])
def test_mesh_raises_and_entry_points_default_to_the_card(fit_data, tmp_path, key, value):
    """Tensor, sequence and pipeline parallelism name their ROADMAP items;
    a data axis of 2 in one process raises the world-size error (the mesh
    must hold every process; tests/test_torch_port_parallel.py runs it over
    two)."""
    cfg = _fit_config([f"trainer.out_dir={tmp_path}", _datasets(fit_data, ("VLSet",)),
                       "data.vl_trans={max_tokens: 64, max_tokens_z: 4}"])
    tok = build_tokenizer(cfg["tokenizer"])
    args = (build_model(cfg["model"], tok), build_dataset(cfg["data"], tok, TINY.parent),
            build(OptimizerConfig, cfg["optimizer"]), build(LoraConfig, cfg["lora"]))
    error, match = {"mesh_model": (NotImplementedError, "Queue 1 item 8b"),
                    "mesh_seq": (NotImplementedError, "Queue 1 item 8c"),
                    "mesh_pipe": (NotImplementedError, "Queue 1 item 8c"),
                    "mesh_data": (ValueError, "must hold every one of the 1 processes")}[key]
    with pytest.raises(error, match=match):
        Trainer(*args, build(TrainerConfig, {**cfg["trainer"], key: value}), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(*args, build(TrainerConfig, cfg["trainer"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit", "-c", str(TINY), f"trainer.out_dir={tmp_path}",
                  _datasets(fit_data, ("SegSet",))])


def test_fit_buckets_take_the_attention_kernels(tmp_path):
    """The buckets chip_smoke.py's fits produce (plans only, no pixels):
    the flagship fit's is S = 1024 with 256 vision tokens over (3, 64, 256,
    256) images (a ViT of 2,049 tokens a sample), and every flash site of
    the tiny and the flagship config (the LLM in bf16, the ViT in fp32 over
    the fp32 image, the SAM encoder in fp32) takes K3 and K7 at its head
    dim."""
    items = [{"key": f"case{i}", "image": [str(tmp_path / f"case{i}.pt")],
              "shape": [list(chip_smoke.FIT_VOLUME)], "modality": ["CT"],
              "processed_report": "Findings: " + "no focal lesion " * 54} for i in range(2)]
    (tmp_path / "train-processed.json").write_text(json.dumps(items))
    data = {"conf": chip_smoke.PHASE_VLM_DATA["conf"],
            "vl_trans": {**chip_smoke.PHASE_VLM_DATA["vl_trans"], "log2_patch_size_z_std": 0},
            "datasets": [{"name": "CT-RATE", "type": "vl", "dir": str(tmp_path)}]}
    ds = build_dataset(data, build_tokenizer(None), tmp_path)
    plans = list(ds.plan_stream(4, seed=0))
    assert {(p["image_shape"], p["patch_size"], p["pool_size"], min(p["seq_len"], 1024))
            for p in plans} == {((3, 64, 256, 256), (8, 16, 16), (2, 2, 2), 1024)}
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig

    tiny = build(MMMMConfig, chip_smoke.TINY_FIT["model"])
    for cfg in (tiny, MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())):
        sites = [(cfg.vlm.hidden_size // cfg.vlm.num_attention_heads, torch.bfloat16),
                 (cfg.vlm.hidden_size // cfg.vlm.num_attention_heads, torch.float32),
                 (cfg.vlm.vision.hidden_size // cfg.vlm.vision.num_heads, torch.float32),
                 (cfg.sam.embed_dim // cfg.sam.encoder_num_heads, torch.float32)]
        for d, dt in sites:
            assert kernel_head_dim(d, dt) == d, (d, dt)
