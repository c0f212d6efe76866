"""The port's ``finetune`` command (``python -m mmmm_tpu_torch.cli finetune``)
against the JAX package's ``scripts/finetune/cli.py`` on the CPU.

Both run conf/tiny/fit.yaml in fp32 (``bf16_vlm`` and ``frozen_vlm_bf16``
off, ``lora.dropout`` 0: the packages draw different dropout masks) for 3
steps over one synthetic VQA dataset, under ``trainer.remat=attn`` (the
override reaches both trainers as the string), first fresh, then
warm-started with ``--init-adapter`` from the ``adapter.npz`` the JAX run
wrote with its ``save_adapter``. Both start from one initial state: the
JAX ``init_train_state`` made from a seeded numpy model tree (in place of
``model.init``, 32 s here; tests/test_torch_port_train.py's ``jax_state0``),
bridged into the port with ``train_state_from_jax`` (the warm start then
replaces the trainable tree and the optimizer state, as the JAX command's
step-0 checkpoint does):
every step's ``lm_loss`` within 1e-5 relative, ``grad_norm`` within 1e-4.
``--task report`` sets ``report_ratio`` 1, ``--task vqa`` both ratios 0,
and a ratio the config sets stays.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from mmmm_tpu.peft import lora as jlora
from mmmm_tpu.train import trainer as jtrainer
from mmmm_tpu.train.step import TrainState as JaxTrainState
from mmmm_tpu_torch import cli, train_state_from_jax
from mmmm_tpu_torch.build import build_model, build_tokenizer
from mmmm_tpu_torch.config import apply_overrides, load_yaml, resolve_interpolations
from test_torch_port_models import numpy_params
from test_torch_port_remat import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"
sys.path.insert(0, str(ROOT / "scripts"))
from finetune import cli as jax_finetune  # noqa: E402

STEPS = 3


@pytest.fixture(scope="module")
def vqa_dir(tmp_path_factory):
    return chip_smoke.write_vl_dataset(tmp_path_factory.mktemp("ft") / "VQASet", 4,
                                       (1, 8, 32, 32), report_chars=120, seed=3)


def _overrides(out: Path) -> list:
    return ["trainer.bf16_vlm=false", "trainer.frozen_vlm_bf16=false", "lora.dropout=0",
            f"trainer.max_steps={STEPS}", "trainer.remat=attn", f"trainer.out_dir={out}",
            "data.vl_trans={max_tokens: 64, max_tokens_z: 4}"]


def _argv(vqa_dir, out, adapter=None):
    warm = ["--init-adapter", str(adapter)] if adapter else []
    return ["-c", str(TINY), "--dataset-dir", str(vqa_dir), *warm, *_overrides(out)]


def _metrics(out: Path) -> list:
    return [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_runs(vqa_dir, tmp_path_factory):
    """The JAX command fresh, then warm-started from its own adapter, with
    one JAX device (its Trainer then makes no mesh), from the seeded initial
    state; the second run takes the first run's steps (one config; a step's
    compile costs 10 s). Returns the runs' root and the initial state."""
    root = tmp_path_factory.mktemp("jax")
    mp = pytest.MonkeyPatch()
    one = jax.devices()[:1]
    mp.setattr(jax, "devices", lambda *a, **k: one)
    seen = []

    def seeded(key, model, optimizer, lora_cfg, dtype=None, frozen_vlm_bf16=False):
        assert not frozen_vlm_bf16
        tree = jax.tree.map(jnp.asarray, numpy_params(_port_cfg(), 0))
        ft, frozen = jlora.split_trainable(tree)
        trainable = {"lora": jlora.lora_init(jax.random.fold_in(key, 1), tree, lora_cfg),
                     "ft": ft}
        state = JaxTrainState(jnp.zeros((), jnp.int32), trainable, optimizer.init(trainable))
        seen.append(jax.device_get((state, frozen)))
        return state, frozen

    mp.setattr(jtrainer, "init_train_state", seeded)
    make_step, steps = jtrainer.make_train_step, {}

    def shared(*a, vg_mode, **k):
        if vg_mode not in steps:
            steps[vg_mode] = make_step(*a, vg_mode=vg_mode, **k)
        return steps[vg_mode]

    mp.setattr(jtrainer, "make_train_step", shared)
    try:
        jax_finetune.main(_argv(vqa_dir, root / "fresh"))
        jax_finetune.main(_argv(vqa_dir, root / "warm", root / "fresh" / "adapter.npz"))
    finally:
        mp.undo()
    return root, seen[0]


def _port_cfg():
    cfg = resolve_interpolations(apply_overrides(load_yaml(TINY, resolve=False), []))
    return build_model(cfg["model"], build_tokenizer(cfg.get("tokenizer"))).cfg


def _port_start(init):
    return train_state_from_jax(*init, "cpu", cfg=_port_cfg())


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "init_adapter"])
def test_finetune_matches_jax(jax_runs, vqa_dir, tmp_path, warm):
    root, init = jax_runs
    ref = root / ("warm" if warm else "fresh")
    adapter = root / "fresh" / "adapter.npz" if warm else None
    args = cli.parse_args(["finetune", "--device", "cpu", *_argv(vqa_dir, tmp_path, adapter)])
    trainer = cli.cmd_finetune(args, state=_port_start(init))
    assert trainer.cfg.remat == "attn"
    got, want = _metrics(tmp_path), _metrics(ref)
    assert [m["step"] for m in got] == [m["step"] for m in want] == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["lm_loss"], w["lm_loss"], rtol=1e-5, err_msg=str(g["step"]))
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=str(g["step"]))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == sorted(
        p.name for p in (ref / "ckpt").iterdir() if p.name.isdigit())
    if warm:  # the warm start's step-0 checkpoint, and another start
        assert (tmp_path / "ckpt" / "0").is_dir()
        assert got[0]["lm_loss"] != _metrics(root / "fresh")[0]["lm_loss"]


def test_finetune_task_ratios(vqa_dir, tmp_path):
    def ratios(task, vl_trans=None):
        cfg = {"data": {} if vl_trans is None else {"vl_trans": dict(vl_trans)}}
        return cli.finetune_config(cfg, vqa_dir, task)["data"]

    data = ratios("report")
    assert data["vl_trans"] == {"report_ratio": 1.0}
    assert data["datasets"] == [{"name": "VQASet", "type": "vl", "dir": str(vqa_dir)}]
    assert ratios("vqa")["vl_trans"] == {"report_ratio": 0.0, "ac_ratio": 0.0}
    assert ratios("vqa", {"ac_ratio": 0.5})["vl_trans"] == {"report_ratio": 0.0, "ac_ratio": 0.5}
    with pytest.raises(ValueError, match="task"):
        ratios("caption")
    args = cli.parse_args(["finetune", "--task", "report", "--device", "cpu",
                           *_argv(vqa_dir, tmp_path)[:4], f"trainer.out_dir={tmp_path}",
                           "trainer.max_steps=1", "data.vl_trans={max_tokens: 64}"])
    trainer = cli.cmd_finetune(args)
    assert trainer.dataset.conf.vl_trans.report_ratio == 1.0
    assert np.isfinite(_metrics(tmp_path)[0]["lm_loss"])


def test_chip_smoke_finetune_config_mirrors_the_yaml():
    """``chip_smoke.FT_VQA`` (the card has no PyYAML) is
    conf/finetune/mmmm-vqa.yaml as ``load_yaml`` resolves it, less the model
    and LoRA it includes (the flagship and ``LORA_YAML``)."""
    cfg = resolve_interpolations(load_yaml(ROOT / "conf" / "finetune" / "mmmm-vqa.yaml",
                                           resolve=False))
    assert cfg["lora"] == chip_smoke.LORA_YAML
    assert {k: v for k, v in cfg.items() if k not in ("model", "lora")} == chip_smoke.FT_VQA
