"""The port's LoRA training step against ``mmmm_tpu.train.make_train_step`` at
``MMMMConfig.tiny()`` on the CPU, and its parts (LoRA, the optimizer)
against ``mmmm_tpu.peft`` and optax.

The step starts from one JAX ``TrainState`` (a seeded numpy model tree,
``lora_init``, ``optax`` state), carried into the port with
``train_state_from_jax``; both sides then take three steps on the same
batch (the layout of ``scripts/bench_train.py --config tiny``: B=2, S=32,
a (3, 4, 16, 16) image whose 18 vision tokens sit at [1, 19), 2 grounding
targets), ``vis_span="auto"``, warmup 1 (step 1 has lr 0; the LoRA ``b``
factors start at zero, so ``a`` gets its first gradient in step 3) and
``dropout_seed=None``. After each step, in fp32: along the port's own
trajectory, the loss within 1e-5 relative; and one port step from the JAX
state before the step: every parameter within 2 * lr of JAX's (Adam moves
a parameter by about lr whatever its gradient's size, so a near-zero
gradient whose sign differs moves it the other way; such moves add up
along a trajectory) and the gradients: every leaf of Adam's
first moment (``b1 * mu + (1 - b1) * clip(g)``, ``mu`` bridged) within
1e-4 of its largest magnitude plus 1e-6 of the largest over all leaves
(fp32 rounding noise, relative to the whole gradient, of a leaf whose
gradient is small or zero in exact arithmetic, such as instance SAM's
final-attention key weights) and ``grad_norm`` (before clipping) within
1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import MMMMModel
from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.peft import lora as jlora
from mmmm_tpu.train import OptimizerConfig as JaxOptimizerConfig
from mmmm_tpu.train import make_optimizer as jax_make_optimizer
from mmmm_tpu.train import make_train_step as jax_make_train_step
from mmmm_tpu.train.step import TrainState as JaxTrainState
from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, make_optimizer,
                            make_train_step, train_state_from_jax)
from mmmm_tpu_torch.peft import lora as plora
from mmmm_tpu_torch.peft.lora import flatten
from mmmm_tpu_torch.train import optim as poptim
from test_torch_port_models import numpy_params, one_thread  # noqa: F401

B, S, N_VIS, TARGETS, LMAX = 2, 32, 18, 2, 6
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, max_steps=10)
LORA = dict(r=4, alpha=8.0)
STEPS = 3


def train_batch(mode: str, with_masks: bool = False, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tt = np.zeros((B, S), np.int32)
    tt[:, 1:1 + N_VIS] = 1
    labels = np.full((B, S), -100, np.int32)
    labels[:, N_VIS + 2:] = rng.integers(4, 120, size=(B, S - N_VIS - 2))
    batch = {
        "input_ids": rng.integers(4, 120, size=(B, S)).astype(np.int32),
        "token_type_ids": tt,
        "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
        "attention_mask": np.ones((B, S), np.int32),
        "labels": labels,
        "weight": rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32),
        "image": rng.normal(size=(B, 3, 4, 16, 16)).astype(np.float32),
        "patch_size": (4, 4, 4),
        "pool_size": (1, 1, 1),
    }
    if mode == "none":
        return batch
    batch["grounding_image"] = rng.normal(size=(B, 3, 4, 16, 16)).astype(np.float32)
    batch["vg_positions"] = rng.integers(N_VIS + 2, S - 1, size=(B, TARGETS)).astype(np.int32)
    batch["vg_valid"] = np.array([[True, True], [True, False]])
    if mode == "semantic":
        batch["masks"] = rng.uniform(size=(B, TARGETS, 4, 16, 16)) > 0.8
    else:
        batch["boxes_label"] = rng.uniform(0.2, 0.8, size=(B, LMAX, 6)).astype(np.float32)
        offs = np.zeros((B, TARGETS, 2), np.int32)
        offs[:, 0] = (0, 2)  # two boxes for target 0, none for target 1
        offs[:, 1] = (2, 2)
        batch["index_offsets"] = offs
        if with_masks:
            batch["masks_label"] = rng.uniform(size=(B, LMAX, 4, 16, 16)) > 0.7
    return batch


def jax_state0(bf16: bool):
    """The JAX TrainState at step 0 and its frozen tree, from the seeded
    numpy model (``init_train_state`` without ``model.init``)."""
    tree = jax.tree.map(jnp.asarray, numpy_params(MMMMConfig.tiny(), 0))
    lcfg = JaxLoraConfig(**LORA)
    lora = jlora.lora_init(jax.random.PRNGKey(1), tree, lcfg)
    ft, frozen = jlora.split_trainable(tree)
    if bf16:
        frozen = dict(frozen, cogvlm=jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                                  frozen["cogvlm"]))
    trainable = {"lora": lora, "ft": ft}
    opt = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    return JaxTrainState(jnp.zeros((), jnp.int32), trainable, opt.init(trainable)), frozen


@functools.lru_cache(maxsize=None)
def jax_run(mode: str, with_masks: bool, attn: str, remat: bool, bf16: bool = False):
    """States after steps 0..3 and the logs of steps 1..3 of the JAX step."""
    state, frozen = jax_state0(bf16)
    step = jax_make_train_step(
        MMMMModel(JaxConfig.tiny()), jax_make_optimizer(JaxOptimizerConfig(**OPT)),
        JaxLoraConfig(**LORA), vg_mode=mode, bf16_vlm=bf16, attn_impl=attn, remat=remat,
        donate=False, dropout_seed=None, vis_span="auto")
    batch = train_batch(mode, with_masks)
    states, logs = [state], []
    for _ in range(STEPS):
        state, log = step(state, frozen, batch)
        states.append(state)
        logs.append({k: float(v) for k, v in log.items()})
    return states, frozen, logs


def port_step(mode: str, attn: str, remat: bool, bf16: bool = False):
    return make_train_step(MMMMConfig.tiny(), make_optimizer(OptimizerConfig(**OPT)),
                           LoraConfig(**LORA), vg_mode=mode, bf16_vlm=bf16, attn_impl=attn,
                           remat=remat, dropout_seed=None, vis_span="auto", device="cpu")


def _np(t):
    return t.detach().float().numpy()


def assert_trajectory_close(got, ref, logs, ref_logs, step: int):
    loss_key = "loss" if "loss" in ref_logs else "lm_loss"
    np.testing.assert_allclose(float(logs[loss_key]), ref_logs[loss_key], rtol=1e-5,
                               err_msg=f"step {step} loss")
    assert got.step == int(ref.step) == step and got.opt_state["count"] == step


def assert_update_close(got, ref, logs, ref_logs, step: int):
    """One step from a shared state: gradients (through Adam's mu and the
    gradient norm) and the updated parameters."""
    np.testing.assert_allclose(float(logs["grad_norm"]), ref_logs["grad_norm"], rtol=1e-5,
                               err_msg=f"step {step} grad_norm")
    ref_p = flatten(jax.tree.map(np.asarray, ref.trainable))
    for path, t in flatten(got.trainable).items():
        np.testing.assert_allclose(_np(t), ref_p[path], rtol=0, atol=2 * LR,
                                   err_msg=f"step {step} parameter {path}")
    (adam,) = [n for n in jax.tree.leaves(ref.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(n, "mu")]
    ref_mu = flatten(jax.tree.map(np.asarray, adam.mu))
    floor = 1e-6 * max(np.abs(r).max() for r in ref_mu.values())
    readings = {}  # leaf -> (error over tolerance, over the tolerance without the floor)
    for path, t in got.opt_state["mu"].items():
        r = ref_mu[path]
        err, top = np.abs(_np(t) - r).max(), np.abs(r).max()
        readings[path] = (err / (1e-4 * top + floor), err / (1e-4 * top) if top > 0 else None)
        np.testing.assert_allclose(_np(t), r, rtol=0, atol=1e-4 * top + floor,
                                   err_msg=f"step {step} gradient (mu) {path}")
    return readings


def check_steps(states, frozen, ref_logs, step, batch):
    """Three port steps from ``states[0]`` against the JAX trajectory, and at
    each step one port step from the JAX state before it. Returns each
    step's Adam mu readings (``assert_update_close``)."""
    state, pfrozen = train_state_from_jax(states[0], frozen, "cpu")
    readings = []
    for i in range(STEPS):
        state, logs = step(state, pfrozen, batch)
        assert_trajectory_close(state, states[i + 1], logs, ref_logs[i], i + 1)
        fresh, _ = train_state_from_jax(states[i], frozen, "cpu")
        fresh, flogs = step(fresh, pfrozen, batch)
        readings.append(assert_update_close(fresh, states[i + 1], flogs, ref_logs[i], i + 1))
    return readings


# each JAX reference (one compile each) is held against all four port
# combinations of attention route and remat
JAX_REFS = {"none": ("none", False, "xla", True),
            "semantic": ("semantic", False, "pallas", True)}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(JAX_REFS))
def test_train_step_matches_jax(case, attn, remat):
    mode, with_masks, jattn, jremat = JAX_REFS[case]
    states, frozen, ref_logs = jax_run(mode, with_masks, jattn, jremat)
    check_steps(states, frozen, ref_logs, port_step(mode, attn, remat),
                train_batch(mode, with_masks))


def test_train_step_bf16_vlm():
    """``bf16_vlm=True`` over a bf16 frozen CogVLM (the flagship recipe):
    bf16 rounds at other places in the two frameworks, so the loss is held
    within 1e-2 and the gradient norm within 5e-2, relative, each step."""
    states, frozen, ref_logs = jax_run("semantic", False, "xla", True, bf16=True)
    state, pfrozen = train_state_from_jax(states[0], frozen, "cpu")
    assert pfrozen["cogvlm"]["llm"]["lm_head"].dtype == torch.bfloat16
    step = port_step("semantic", "pallas", True, bf16=True)
    batch = train_batch("semantic")
    for i in range(STEPS):
        state, logs = step(state, pfrozen, batch)
        np.testing.assert_allclose(float(logs["loss"]), ref_logs[i]["loss"], rtol=1e-2)
        np.testing.assert_allclose(float(logs["grad_norm"]), ref_logs[i]["grad_norm"],
                                   rtol=5e-2)
        assert state.trainable["ft"]["cogvlm"]["llm"]["embed_tokens"].dtype == torch.float32


def test_train_state_from_jax_resumes():
    """JAX steps 1-2, then the port's step 3 from the carried state, equal to
    JAX step 3 within the fp32 tolerances."""
    states, frozen, ref_logs = jax_run("none", False, "xla", True)
    state, pfrozen = train_state_from_jax(states[2], frozen, "cpu")
    assert state.step == 2 and state.opt_state["count"] == 2
    state, logs = port_step("none", "xla", True)(state, pfrozen, train_batch("none"))
    assert_trajectory_close(state, states[3], logs, ref_logs[2], 3)
    assert_update_close(state, states[3], logs, ref_logs[2], 3)


def test_train_state_from_jax_refuses_a_bad_tree():
    states, frozen, _ = jax_run("none", False, "xla", True)
    bad = dict(frozen, vg_proj={"w9": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        train_state_from_jax(states[0], bad, "cpu")
    # a mesh trains data and tensor parallel (tests/test_torch_port_parallel.py,
    # tests/test_torch_port_tensor_parallel.py); a model axis with a pipeline
    # axis raises, as the reference's pipeline does
    with pytest.raises(ValueError, match="model>1 XOR pipe>1"):
        make_train_step(MMMMConfig.tiny(), make_optimizer(OptimizerConfig()), LoraConfig(),
                        mesh={"pipe": 2, "data": 1, "model": 2}, device="cpu")


def test_lora_merge_matches_jax():
    """``lora_merge`` without dropout, materialized, against the JAX merge
    (random ``b`` so the delta is not zero); targets and split agree."""
    tree = numpy_params(MMMMConfig.tiny(), 1)
    rng = np.random.default_rng(2)
    lcfg = JaxLoraConfig(**LORA)
    lora = jax.tree.map(np.asarray, jlora.lora_init(jax.random.PRNGKey(3), tree, lcfg))
    lora = jax.tree.map(lambda x: (x + rng.normal(size=x.shape) * 0.1).astype(np.float32), lora)
    ref = flatten(jax.tree.map(np.asarray, jlora.lora_merge(tree, lora, lcfg)))
    pt = jax.tree.map(torch.from_numpy, tree)
    got = flatten(plora.materialize(plora.lora_merge(
        pt, jax.tree.map(torch.from_numpy, lora), LoraConfig(**LORA))))
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path].numpy(), r, rtol=0, atol=1e-6, err_msg=path)
    assert plora.default_lora_targets(pt) == jlora.default_lora_targets(tree)
    jft, jfrozen = jlora.split_trainable(tree)
    pft, pfrozen = plora.split_trainable(pt)
    assert set(flatten(pft)) == set(flatten(jft)) and set(flatten(pfrozen)) == set(flatten(jfrozen))


def test_lora_dropout_mask():
    """The mask is deterministic in (seed, step, leaf), keeps 0.95 +- 0.01 of
    a large leaf's rows, and survivors are scaled by 1 / (1 - p)."""
    cfg = LoraConfig(r=2, alpha=2.0, use_rslora=False, dropout=0.05)
    base = {"cogvlm": {"llm": {"lm_head": torch.zeros(20000, 3)}}}
    lora = {"cogvlm": {"llm": {"lm_head": {"a": torch.ones(20000, 2),
                                           "b": torch.ones(2, 3)}}}}
    leaf = plora.lora_merge(base, lora, cfg, dropout=(7, 3))["cogvlm"]["llm"]["lm_head"]
    again = plora.lora_merge(base, lora, cfg, dropout=(7, 3))["cogvlm"]["llm"]["lm_head"]
    other = plora.lora_merge(base, lora, cfg, dropout=(7, 4))["cogvlm"]["llm"]["lm_head"]
    assert torch.equal(leaf.keep, again.keep) and not torch.equal(leaf.keep, other.keep)
    assert abs(leaf.keep.float().mean().item() - 0.95) < 0.01
    w = leaf.merge()  # rows kept: (a / (1 - p)) @ b * scale = 2 / 0.95
    kept = leaf.keep[:, 0]
    torch.testing.assert_close(w[kept], torch.full_like(w[kept], 2 / 0.95))
    assert torch.all(w[~kept] == 0)
    assert plora.lora_merge(base, lora, cfg)["cogvlm"]["llm"]["lm_head"].keep is None


def test_optimizer_matches_optax():
    """clip + AdamW against ``make_optimizer`` (optax) over 3 steps on a small
    tree with masked (no-decay) leaves, a leaf with no gradient and a
    gradient norm above the clip, within 1e-6 of each parameter."""
    rng = np.random.default_rng(0)
    tree = {"lora": {"x": {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=(3, 5))}},
            "ft": {"sam": {"w": rng.normal(size=(5, 5)), "norm_w": rng.normal(size=(5,)),
                           "idle_w": rng.normal(size=(3, 3))}}}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    cfg = dict(lr=0.1, warmup_steps=2, max_steps=6, grad_clip_norm=1.0, weight_decay=0.1)
    jopt = jax_make_optimizer(JaxOptimizerConfig(**cfg))
    jstate, jparams = jopt.init(tree), jax.tree.map(jnp.asarray, tree)
    popt = make_optimizer(OptimizerConfig(**cfg))
    pparams = {p: torch.from_numpy(v.copy()) for p, v in flatten(tree).items()}
    pstate = popt.init(pparams)
    for i in range(3):
        grads = jax.tree.map(lambda x: (rng.normal(size=x.shape) * (3 - i)).astype(np.float32),
                             tree)
        grads["ft"]["sam"]["idle_w"] = np.zeros((3, 3), np.float32)  # no gradient
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pg = {p: torch.from_numpy(v) for p, v in flatten(grads).items()}
        pg["ft/sam/idle_w"] = None
        norm = popt.step(pparams, pg, pstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for path, r in flatten(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_allclose(pparams[path].numpy(), r, rtol=0, atol=1e-6,
                                       err_msg=f"step {i + 1} {path}")
    assert {p: poptim.decays(p, t) for p, t in pparams.items()} == {
        "lora/x/a": True, "lora/x/b": False, "ft/sam/w": True, "ft/sam/norm_w": False,
        "ft/sam/idle_w": True}
    assert poptim.schedule(OptimizerConfig(**cfg), 0) == 0.0


if __name__ == "__main__":
    # the readings behind the Adam mu tolerance's 1e-6 floor: for every case
    # of the parity tests here and in test_torch_port_train_instance.py, the
    # largest error over tolerance, and the largest error over 1e-4 of a
    # leaf's own largest magnitude (no floor), with its leaf and step, and
    # the leaves that pass only with the floor. Run from the repository root:
    # PYTHONPATH=.:tests python tests/test_torch_port_train.py
    import test_torch_port_train_instance as inst

    cases = {**{c: JAX_REFS[c] for c in JAX_REFS}, **inst.JAX_REFS}
    for case, (mode, with_masks, jattn, jremat) in cases.items():
        states, frozen, ref_logs = jax_run(mode, with_masks, jattn, jremat)
        for attn in ("xla", "pallas"):
            for remat in (True, False):
                steps = check_steps(states, frozen, ref_logs, port_step(mode, attn, remat),
                                    train_batch(mode, with_masks))
                tol = max((v[0], p, i + 1) for i, r in enumerate(steps) for p, v in r.items())
                bare = max((v[1], p, i + 1) for i, r in enumerate(steps) for p, v in r.items()
                           if v[1] is not None)
                over = {}  # leaf -> its largest reading without the floor, where over 1
                for r in steps:
                    for p, v in r.items():
                        if v[1] is not None and v[1] > 1:
                            over[p] = max(over.get(p, 0.0), v[1])
                zero = {p for r in steps for p, v in r.items() if v[1] is None}
                print(f"{case} attn={attn} remat={remat}: with floor {tol[0]:.4e} ({tol[1]}, "
                      f"step {tol[2]}); without {bare[0]:.4e} ({bare[1]}, step {bare[2]}); "
                      f"{len(zero)} leaves 0 in JAX at some step; over 1 without the floor: "
                      + ", ".join(f"{p} {v:.3g}" for p, v in sorted(over.items())), flush=True)
