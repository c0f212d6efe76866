"""Stage-0 SAM alignment of the port (``models/align.py``, ``data/align.py``,
``params.init_sam_params``, ``python -m mmmm_tpu_torch.cli align-sam``)
against the JAX package's, on the CPU.

``align_training_step`` from one SAM tree (the JAX package's
``init_sam_params``, leaves carried over as tensors) on one patch batch of
``AlignPatchTransform``, semantic and instance: loss and logs within 1e-5
relative; the gradient (all leaves as one vector) within 1e-5 relative in
norm, and each leaf within 1e-4 of its largest magnitude plus 1e-6 of the
largest over all leaves (the tolerance of tests/test_torch_port_train.py:
the key biases' gradients are zero in exact arithmetic, and sums whose
terms cancel keep fp32 noise near 1e-5 of a leaf's largest). Instance
takes each tolerance 10x: on this batch each package's fp32 gradient
stands 2.3e-5 (JAX) and 2.9e-5 (the port) from the port's float64
gradient in norm, so fp32 noise alone exceeds 1e-5. The patch transform gives JAX's
patches under one seed; ``init_sam_params`` has the JAX tree's layout; the
CLI's ``sam_aligned.npz`` is read by ``mmmm_tpu.train.checkpoint.load_adapter``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.data import align as jdata_align
from mmmm_tpu.data.local import get_local_data_list as jax_local_list
from mmmm_tpu.models import align as jalign
from mmmm_tpu.models.segvol import SamConfig as JaxSamConfig
from mmmm_tpu.models.segvol import init_sam_params as jax_init_sam_params
from mmmm_tpu.train.checkpoint import load_adapter as jax_load_adapter
from mmmm_tpu_torch import cli
from mmmm_tpu_torch.data import align as pdata_align
from mmmm_tpu_torch.data.local import get_local_data_list
from mmmm_tpu_torch.models import align as palign
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.params import init_sam_params
from mmmm_tpu_torch.peft.lora import flatten, unflatten
from test_data_pipeline import _make_seg_case
from test_torch_port_models import one_thread  # noqa: F401

C2I = {"liver": 0, "nodule": 1, "spleen": 2, "pleural effusion": 3}
PATCH = dict(patch_shape=(4, 16, 16), patch_size_z=2, max_classes=3, num_neg=1)


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("align") / "SegSet"
    for i in range(2):
        _make_seg_case(root, f"case{i}", rng=np.random.default_rng(i))
    return root


def _jax_sam_shapes(instance: bool) -> dict:
    tree = jax.eval_shape(lambda: jax_init_sam_params(jax.random.PRNGKey(0), JaxSamConfig.tiny(),
                                                      instance=instance))
    return {p: tuple(a.shape) for p, a in _flat_np(tree, leaf=lambda a: a).items()}


def _flat_np(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat_np(v, p, leaf) if isinstance(v, dict) else {p: leaf(v)})
    return out


def test_patch_transform_matches_jax(seg_root):
    ptf = pdata_align.AlignPatchTransform(pdata_align.AlignTransConf(**PATCH), C2I, seed=3)
    jtf = jdata_align.AlignPatchTransform(jdata_align.AlignTransConf(**PATCH), C2I, seed=3)
    pitems, jitems = get_local_data_list(seg_root), jax_local_list(seg_root)
    points = {"p": [], "j": []}
    for _ in range(4):
        for pi, ji in zip(pitems, jitems):
            points["p"].append(ptf(pi))
            points["j"].append(jtf(ji))
    got = pdata_align.collate_align(points["p"])
    want = jdata_align.collate_align(points["j"])
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w
    assert want["masks"].any()


@pytest.mark.parametrize("instance", [False, True])
def test_init_sam_params_has_the_jax_layout(instance):
    want = _jax_sam_shapes(instance)
    got = flatten(init_sam_params(SamConfig.tiny(), instance, seed=0, device="cpu"))
    assert {p: tuple(t.shape) for p, t in got.items()} == want
    assert all(t.dtype == torch.float32 for t in got.values())


def _align_batch(seg_root, instance: bool) -> dict:
    tf = jdata_align.AlignPatchTransform(jdata_align.AlignTransConf(**PATCH), C2I, seed=1)
    items = jax_local_list(seg_root)
    batch = jdata_align.collate_align([tf(items[0]), tf(items[1])])
    batch["patch_size"] = (2, 4, 4)
    if instance:
        rng = np.random.default_rng(2)
        batch["boxes_label"] = rng.uniform(0.2, 0.8, size=(2, 6, 6)).astype(np.float32)
        batch["index_offsets"] = np.array([[[0, 2], [2, 3], [3, 3]]] * 2, np.int32)
    return batch


@pytest.mark.parametrize("instance,grad_tol", [(False, 1e-5), (True, 1e-4)])
def test_align_training_step_matches_jax(seg_root, instance, grad_tol):
    leaf_tol, floor = 10 * grad_tol, grad_tol / 10
    sam = JaxSamConfig.tiny()
    jparams = jax_init_sam_params(jax.random.PRNGKey(0), sam, instance=instance)
    embeds = np.random.default_rng(0).normal(size=(4, sam.embed_dim)).astype(np.float32) * 0.5
    batch = _align_batch(seg_root, instance)
    jcfg = jalign.AlignConfig(sam=sam, instance=instance)
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    (jloss, jlog), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jalign.align_training_step(p, jcfg, jnp.asarray(embeds),
                                                {**b, "patch_size": (2, 4, 4)}, attn_impl="xla"),
        has_aux=True))(jparams, {k: v for k, v in jb.items() if k != "patch_size"})

    flat = {p: torch.from_numpy(a.copy()).requires_grad_(True)
            for p, a in _flat_np(jparams).items()}
    pb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    pcfg = palign.AlignConfig(sam=SamConfig.tiny(), instance=instance)
    loss, log = palign.align_training_step(unflatten(flat), pcfg, torch.from_numpy(embeds), pb,
                                           attn_impl="pallas")
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()), allow_unused=True)))

    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(log) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(log[k].item(), float(jlog[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = _flat_np(jgrads)
    got = {p: np.zeros_like(g) if grads[p] is None else grads[p].numpy()
           for p, g in want.items()}
    dist = sum(np.square(got[p] - g).sum() for p, g in want.items())
    norm = sum(np.square(g).sum() for g in want.values())
    assert (dist / norm) ** 0.5 <= grad_tol, (dist / norm) ** 0.5
    scale = max(np.abs(g).max() for g in want.values())
    for p, g in want.items():
        err = np.abs(got[p] - g).max()
        assert err <= leaf_tol * np.abs(g).max() + floor * scale, (p, err, np.abs(g).max(), scale)


def test_align_sam_cli(seg_root, tmp_path):
    """``python -m mmmm_tpu_torch.cli align-sam`` on the CPU, the JAX CLI
    test's config: 3 steps logged, and ``sam_aligned.npz`` read by the JAX
    package's ``load_adapter`` as a SAM tree of its layout."""
    cfg = tmp_path / "fit.yaml"
    cfg.write_text(f"""
sam:
  embed_dim: 32
  encoder_num_layers: 2
  encoder_num_heads: 4
  patch_size: [4, 4, 4]
  pos_embed_shape: [2, 4, 4]
  num_instances: 3
  decoder_mlp_dim: 64
align:
  patch_shape: [4, 16, 16]
  patch_size_z: 2
  max_classes: 3
  num_neg: 1
vit_patch_size: [2, 4, 4]
optimizer: {{lr: 1.0e-3, warmup_steps: 1, max_steps: 3}}
trainer: {{max_steps: 3, batch_size: 2, log_every: 1, out_dir: {tmp_path}/run}}
data:
  datasets:
    - {{dir: {seg_root}}}
""")
    cli.main(["align-sam", "-c", str(cfg), "--device", "cpu"])
    metrics = [json.loads(line) for line in (tmp_path / "run/metrics.jsonl").read_text()
               .splitlines()]
    assert [m["step"] for m in metrics] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    tree = _flat_np(jax_load_adapter(tmp_path / "run/sam_aligned.npz"))
    assert {p: a.shape for p, a in tree.items()} == _jax_sam_shapes(False)
    # the first step has lr 0 (warmup); later steps move the parameters
    init = flatten(init_sam_params(SamConfig.tiny(), seed=0, device="cpu"))
    assert any(not np.array_equal(tree[p], t.numpy()) for p, t in init.items())
