"""The training step's loss ops against the JAX package on the CPU: fused
blockwise CE (value and ``jax.vjp``), the dense weighted CE, Hungarian
matching, the Dice-focal mask loss, 3-D GIoU, the instance set loss and
``nearest_resize``. fp32 within 1e-5 (relative for losses, of the largest
magnitude for gradients) unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.models.cogvlm import model as jmodel
from mmmm_tpu.models.segvol import loss as jloss
from mmmm_tpu.ops import fused_ce as jce
from mmmm_tpu.ops.hungarian import hungarian as jhungarian
from mmmm_tpu.ops import resample as jres
from mmmm_tpu_torch.models.cogvlm import model as pmodel
from mmmm_tpu_torch.models.segvol import loss as ploss
from mmmm_tpu_torch.ops import fused_ce as pce
from mmmm_tpu_torch.ops import hungarian as phung
from mmmm_tpu_torch.ops import resample as pres

T, C, V, BLOCK = 24, 16, 130, 64  # three vocabulary blocks, the last one partial


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, frac=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got.detach().float()), ref, rtol=0,
                               atol=frac * max(np.abs(ref).max(), 1e-30))


def _ce_inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(2, T // 2, C)).astype(np.float32)
    head = (rng.normal(size=(C, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, size=(2, T // 2)).astype(np.int32)
    labels[0, :3] = -100  # ignored tokens
    labels[1, -1] = V - 1  # a label in the partial last block
    weight = rng.uniform(0.5, 2.0, size=(2, T // 2)).astype(np.float32)
    return hidden, head, labels, weight


def test_fused_ce_matches_jax():
    hidden, head, labels, _ = _ce_inputs()
    h2, lab = hidden.reshape(T, C), np.where(labels < 0, 0, labels).reshape(T)
    g = np.random.default_rng(1).normal(size=(T,)).astype(np.float32)
    ref, vjp = jax.vjp(lambda h, w: jce.fused_ce(h, w, jnp.asarray(lab), BLOCK),
                       jnp.asarray(h2), jnp.asarray(head))
    rdh, rdw = vjp(jnp.asarray(g))
    ph, pw = _t(h2).requires_grad_(), _t(head).requires_grad_()
    got = pce.fused_ce(ph, pw, _t(lab), BLOCK)
    dh, dw = torch.autograd.grad(got, (ph, pw), _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    _close(dh, rdh)
    _close(dw, rdw)


@pytest.mark.parametrize("weighted", [True, False])
def test_fused_weighted_ce_loss_matches_jax_and_dense(weighted):
    hidden, head, labels, weight = _ce_inputs(2)
    w = weight if weighted else None

    def jfn(h, hd):
        return jce.fused_weighted_ce_loss(h, hd, jnp.asarray(labels),
                                          None if w is None else jnp.asarray(w), block_v=BLOCK)

    ref, vjp = jax.vjp(jfn, jnp.asarray(hidden), jnp.asarray(head))
    rdh, rdw = vjp(jnp.ones((), jnp.float32))
    ph, pw = _t(hidden).requires_grad_(), _t(head).requires_grad_()
    got = pce.fused_weighted_ce_loss(ph, pw, _t(labels), None if w is None else _t(w),
                                     block_v=BLOCK)
    dh, dw = torch.autograd.grad(got, (ph, pw))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(dh, rdh)
    _close(dw, rdw)
    # the dense weighted CE on the full logits gives the same loss, in both packages
    dense = pmodel.weighted_ce_loss(_t(hidden) @ _t(head), _t(labels),
                                    None if w is None else _t(w))
    jdense = jmodel.weighted_ce_loss(jnp.asarray(hidden) @ jnp.asarray(head),
                                     jnp.asarray(labels), None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(dense), got.item(), rtol=1e-5)
    np.testing.assert_allclose(float(dense), float(jdense), rtol=1e-5)


def test_fused_ce_bf16_hidden():
    """bf16 hidden and head (the flagship's dtypes): fp32 logits from bf16
    operands on both sides, gradients cast back to bf16 (within 2e-2 of the
    largest)."""
    hidden, head, labels, weight = _ce_inputs(3)
    jh, jw = jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16)
    ref, vjp = jax.vjp(lambda h, w: jce.fused_weighted_ce_loss(
        h, w, jnp.asarray(labels), jnp.asarray(weight), block_v=BLOCK), jh, jw)
    rdh, rdw = vjp(jnp.ones((), jnp.float32))
    to_t = lambda a: torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    ph, pw = to_t(jh).requires_grad_(), to_t(jw).requires_grad_()
    got = pce.fused_weighted_ce_loss(ph, pw, _t(labels), _t(weight), block_v=BLOCK)
    dh, dw = torch.autograd.grad(got, (ph, pw))
    assert dh.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(dh, np.asarray(rdh.astype(jnp.float32)), 2e-2)
    _close(dw, np.asarray(rdw.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_hungarian_matches_jax(n):
    rng = np.random.default_rng(n)
    cost = rng.normal(size=(5, n, n)).astype(np.float32)
    ref = np.stack([np.asarray(jhungarian(jnp.asarray(c))) for c in cost])
    np.testing.assert_array_equal(phung.hungarian(_t(cost)).numpy(), ref)
    # tied costs (two identical negative columns): the summed cost of the
    # chosen assignment is the minimum in both
    tied = cost.copy()
    tied[:, :, -1] = tied[:, :, 0]
    got = phung.hungarian(_t(tied)).numpy()
    for c, g in zip(tied, got):
        r = np.asarray(jhungarian(jnp.asarray(c)))
        np.testing.assert_allclose(c[np.arange(n), g].sum(), c[np.arange(n), r].sum(),
                                   rtol=1e-6)


def test_dice_focal_and_giou_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 3, 4, 8, 8)).astype(np.float32) * 3
    target = (rng.uniform(size=(2, 3, 4, 8, 8)) > 0.7).astype(np.float32)
    valid = np.array([[True, True, False], [True, False, False]])
    for loss in (jloss.DiceFocalLoss(), jloss.DiceFocalLoss(focal_gamma=0.0, focal_alpha=0.25)):
        pl = ploss.DiceFocalLoss(loss.dice_weight, loss.focal_weight, loss.focal_gamma,
                                 loss.focal_alpha)
        ref = loss.masked(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(valid),
                          return_dict=True)
        got = pl.masked(_t(logits), _t(target), _t(valid), return_dict=True)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)
        _close(pl.per_channel(_t(logits), None), loss.per_channel(jnp.asarray(logits), None))
    a = np.concatenate([rng.uniform(0.2, 0.8, (7, 3)), rng.uniform(0.05, 0.4, (7, 3))], -1)
    b = np.concatenate([rng.uniform(0.2, 0.8, (7, 3)), rng.uniform(0.05, 0.4, (7, 3))], -1)
    a[0], b[0] = [0.5] * 3 + [0.0] * 3, [0.1] * 6  # a degenerate box
    _close(ploss.box_pair_giou_3d(_t(a), _t(b)),
           jloss.box_pair_giou_3d(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("with_masks", [False, True])
def test_instance_sample_loss_matches_jax(with_masks):
    """``InstanceSamLoss.sample_loss`` (N=3 targets, K=4 queries, Lmax 6;
    target 0 with 2 positives, target 1 with 3, target 2 padded): loss, log
    and the positive matches; the loss's gradient by ``jax.grad``."""
    rng = np.random.default_rng(5 + with_masks)
    n, k, lmax = 3, 4, 6
    boxes_reg = np.concatenate([rng.uniform(0.2, 0.8, (n, k, 3)),
                                rng.uniform(0.05, 0.4, (n, k, 3))], -1).astype(np.float32)
    disc = rng.normal(size=(n, k)).astype(np.float32)
    boxes_label = np.concatenate([rng.uniform(0.2, 0.8, (lmax, 3)),
                                  rng.uniform(0.05, 0.4, (lmax, 3))], -1).astype(np.float32)
    offs = np.array([[0, 2], [2, 5], [5, 5]], np.int32)
    valid = np.array([True, True, False])
    ml = mld = mlab = mlab_ds = None
    if with_masks:
        ml = rng.normal(size=(n, k, 4, 8, 8)).astype(np.float32)
        mld = rng.normal(size=(n, k, 2, 4, 4)).astype(np.float32)
        mlab = (rng.uniform(size=(lmax, 4, 8, 8)) > 0.6).astype(np.float32)
        mlab_ds = np.asarray(jres.nearest_resize(jnp.asarray(mlab), (2, 4, 4)))
    jl = jloss.InstanceSamLoss(mask_loss=jloss.DiceFocalLoss())
    pl = ploss.InstanceSamLoss(mask_loss=ploss.DiceFocalLoss())
    j = lambda x: None if x is None else jnp.asarray(x)
    p = lambda x: None if x is None else _t(x)

    def jfn(br, dl, m):
        return jl.sample_loss(m, j(mld), br, dl, j(mlab), j(mlab_ds), j(boxes_label), j(offs),
                              j(valid))

    (ref, ref_log), grads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        j(boxes_reg), j(disc), j(ml) if with_masks else None)
    pbr, pdl = _t(boxes_reg).requires_grad_(), _t(disc).requires_grad_()
    pm = _t(ml).requires_grad_() if with_masks else None
    got, log = pl.sample_loss(pm, p(mld), pbr, pdl, p(mlab), p(mlab_ds), _t(boxes_label),
                              _t(offs), _t(valid))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert set(log) == set(ref_log)
    for key in ref_log:
        np.testing.assert_allclose(log[key].item(), float(ref_log[key]), rtol=1e-5, atol=1e-7)
    inputs = (pbr, pdl, pm) if with_masks else (pbr, pdl)
    for t, g, r in zip(inputs, torch.autograd.grad(got, inputs, allow_unused=True), grads):
        _close(torch.zeros_like(t) if g is None else g, r)  # boxes: unused with masks
    # the positive matches agree (negative columns may tie)
    lab_g = np.clip(offs[:, :1] + np.arange(k), 0, lmax - 1)
    jm = np.asarray(jax.vmap(jl.match_one_target)(
        j(boxes_reg), j(disc), j(boxes_label[lab_g]), j(np.clip(offs[:, 1] - offs[:, 0], 0, k))))
    pm_ = pl.match_one_target(_t(boxes_reg), _t(disc), _t(boxes_label[lab_g]),
                              _t(np.clip(offs[:, 1] - offs[:, 0], 0, k))).numpy()
    num_pos = np.clip(offs[:, 1] - offs[:, 0], 0, k)[:, None]
    np.testing.assert_array_equal(np.where(pm_ < num_pos, pm_, -1), np.where(jm < num_pos, jm, -1))


@pytest.mark.parametrize("shape,new", [((2, 6, 8, 16, 16), (2, 4, 4)),
                                       ((3, 5, 7, 9), (3, 4, 12)),
                                       ((4, 10), (3,))])
def test_nearest_resize_bit_equal(shape, new):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    ref = np.asarray(jres.nearest_resize(jnp.asarray(x), new))
    np.testing.assert_array_equal(pres.nearest_resize(_t(x), new).numpy(), ref)
