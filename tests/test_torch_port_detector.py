"""The pseudo-box detector's port against the JAX package on the CPU:
``ops/hungarian.py lap_rectangular`` (the plain version of the kernel LAP),
``ops/deform_attn.py``, ``models/detector.py`` (forward, loss, gradients,
three optimizer steps of ``train_detector``) and its numpy helpers, and the
optimizer forms the detector and seg-exp commands use (``train/optim.py``
against optax). Inputs come from numpy seeds and go through both packages;
the JAX side runs jitted, one compile per function shared through module
fixtures. The commands themselves are held in
tests/test_torch_port_detector_cli.py.

Tolerances: LAP's assignment is compared bit for bit (the same fp32
arithmetic in the same order) and its summed cost with scipy's optimum
within 1e-5 relative; the deformable attention within 1e-5 absolute (unit
values, four-term sums taken in another order); the detector's outputs,
loss and gradients within 1e-4 relative to each tensor's largest entry
(fp32 convolutions and reductions summed in another order; leaves whose
gradient is zero by construction, such as a bias under a one-channel
group norm or the self-attention key bias under the softmax, are held
within 1e-4 of the largest gradient of the tree instead).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from mmmm_tpu.models import detector as jdet
from mmmm_tpu.ops.deform_attn import bilinear_sample as j_bilinear
from mmmm_tpu.ops.deform_attn import ms_deform_attn as j_msda
from mmmm_tpu.ops.hungarian import lap_rectangular as j_lap
from mmmm_tpu_torch.models import detector as tdet
from mmmm_tpu_torch.ops.deform_attn import bilinear_sample, ms_deform_attn
from mmmm_tpu_torch.ops.hungarian import lap_rectangular, lap_rectangular_plain
from mmmm_tpu_torch.params import _flatten, detector_params_from_jax
from mmmm_tpu_torch.train.detector import detector_optimizer, train_detector
from mmmm_tpu_torch.train.optim import AdamW, OptimizerConfig


def _jit(fn):
    """``jax.jit`` with LLVM's optimizations off: the reference compiles in
    a third less time (the detector's loss and gradients take most of this
    file's time) and computes the same HLO, whose fusions XLA chooses
    before LLVM runs."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _costs(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int":  # many ties
        return rng.integers(0, 4, shape).astype(np.float32)
    c = rng.normal(size=shape).astype(np.float32)
    if kind == "padded":  # the matcher's padded GT rows: flat zero
        c[..., shape[-2] // 2:, :] = 0.0
    return c


@pytest.fixture(scope="module")
def jax_lap():
    return _jit(jax.vmap(j_lap))


@pytest.mark.parametrize("shape,kind", [
    ((32, 24, 100), "random"), ((32, 24, 100), "padded"), ((16, 24, 100), "int"),
    ((8, 8, 8), "random"), ((8, 8, 8), "int"), ((8, 1, 5), "random"), ((2, 32, 300), "random"),
])
def test_lap_rectangular_plain_matches_jax_and_scipy(jax_lap, shape, kind):
    c = _costs(shape, kind)
    got = lap_rectangular(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_lap(jnp.asarray(c))))
    k = shape[1]
    for b in range(shape[0]):
        assert len(set(got[b].tolist())) == k
        r, col = linear_sum_assignment(c[b])
        best = c[b][r, col].sum(dtype=np.float64)
        assert abs(c[b][np.arange(k), got[b]].sum(dtype=np.float64) - best) <= 1e-5 * max(
            1.0, abs(best))


def test_lap_rectangular_batched_leading_dims(jax_lap):
    c = _costs((2, 3, 6, 20), "random", seed=3)
    got = lap_rectangular_plain(torch.from_numpy(c))
    assert got.shape == (2, 3, 6) and got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.reshape(6, 6).numpy(), np.asarray(jax_lap(jnp.asarray(c.reshape(6, 6, 20)))))
    with pytest.raises(ValueError, match="K <= Q"):
        lap_rectangular(torch.zeros(5, 4))


def _points(n, rng):
    """Points inside, outside [0, 1] and exactly on pixel centres."""
    pts = rng.uniform(-0.3, 1.3, (n, 2)).astype(np.float32)
    pts[: n // 4] = ((rng.integers(0, 5, (n // 4, 2)) + 0.5) / 5).astype(np.float32)
    return pts


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    value = rng.normal(size=(5, 5, 3)).astype(np.float32)
    pts = _points(40, rng)
    w = rng.normal(size=(40, 3)).astype(np.float32)
    jf = jax.jit(lambda v, p: (j_bilinear(v, p) * w).sum())
    jv, jp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(value), jnp.asarray(pts))
    tv, tp = torch.from_numpy(value).requires_grad_(), torch.from_numpy(pts).requires_grad_()
    out = bilinear_sample(tv, tp)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(_jit(j_bilinear)(value, pts)), atol=1e-5, rtol=0)
    gv, gp = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tv, tp))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)


def test_ms_deform_attn_matches_jax():
    rng = np.random.default_rng(2)
    b, q, heads, hd, p = 2, 6, 2, 4, 3
    shapes = [(5, 7), (3, 4)]
    values = [rng.normal(size=(b, h, w, heads, hd)).astype(np.float32) for h, w in shapes]
    locs = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), p, 2)).astype(np.float32)
    logits = rng.normal(size=(b, q, heads, len(shapes) * p)).astype(np.float32)
    weights = np.asarray(jax.nn.softmax(logits, -1)).reshape(b, q, heads, len(shapes), p)
    ct = rng.normal(size=(b, q, heads * hd)).astype(np.float32)

    def jloss(vals, lo, wt):
        out = j_msda(list(vals), lo, wt)
        return (out * ct).sum(), out

    jg, jout = _jit(jax.grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        tuple(map(jnp.asarray, values)), jnp.asarray(locs), jnp.asarray(weights))
    tvals = [torch.from_numpy(v).requires_grad_() for v in values]
    tl = torch.from_numpy(locs).requires_grad_()
    tw = torch.from_numpy(weights.copy()).requires_grad_()
    out = ms_deform_attn(tvals, tl, tw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [*tvals, tl, tw])
    for g, r in zip(grads, [*jg[0], jg[1], jg[2]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def _tiny_cfgs():
    kw = dict(num_classes=4, d_model=32, n_heads=4, n_points=2, enc_layers=1, dec_layers=2,
              ffn_dim=64, num_queries=12, backbone_dims=(8, 16, 32, 32), image_size=64, max_gt=4)
    return jdet.DetectorConfig(**kw), tdet.DetectorConfig(**kw)


def _batch(rng, b, cfg):
    """Noise images (no near-ties for top_k) and 0-3 GT boxes an image."""
    images = rng.random((b, cfg.image_size, cfg.image_size, 1)).astype(np.float32)
    gb = np.zeros((b, cfg.max_gt, 4), np.float32)
    gc = np.zeros((b, cfg.max_gt), np.int32)
    gv = np.zeros((b, cfg.max_gt), bool)
    for i in range(b):
        n = int(rng.integers(0, cfg.max_gt))
        gb[i, :n] = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.3, (n, 2))],
                                   -1)
        gc[i, :n] = rng.integers(0, cfg.num_classes, n)
        gv[i, :n] = True
    return images, gb, gc, gv


@pytest.fixture(scope="module")
def det():
    jcfg, tcfg = _tiny_cfgs()
    # an "rbg" key: threefry's random bits take the init's compile four times as long
    jparams = _jit(lambda k: jdet.init_detector_params(k, jcfg))(jax.random.key(0, impl="rbg"))
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    loss_grad = _jit(jax.value_and_grad(
        lambda p, im, gb, gc, gv: jdet.detector_loss(p, jcfg, im, gb, gc, gv)))
    fwd = _jit(lambda p, im: jdet.detector_forward(p, jcfg, im))
    return dict(jcfg=jcfg, tcfg=tcfg, nparams=nparams, loss_grad=loss_grad, fwd=fwd)


def _rel_close(got, ref, rtol, scale=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = rtol * (np.abs(ref).max() if scale is None else scale) + 1e-12
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def test_detector_forward_matches_jax(det):
    images, *_ = _batch(np.random.default_rng(4), 2, det["jcfg"])
    params = detector_params_from_jax(det["nparams"], det["tcfg"], "cpu")
    out = tdet.detector_forward(params, det["tcfg"], torch.from_numpy(images))
    ref = det["fwd"](det["nparams"], jnp.asarray(images))
    for k in ("class_logits", "boxes", "enc_logits", "enc_boxes"):
        _rel_close(out[k].detach().numpy(), ref[k], 1e-4)
    assert len(out["aux"]) == len(ref["aux"]) == det["tcfg"].dec_layers - 1
    for (lo, bx), (rlo, rbx) in zip(out["aux"], ref["aux"]):
        _rel_close(lo.detach().numpy(), rlo, 1e-4)
        _rel_close(bx.detach().numpy(), rbx, 1e-4)


def _port_loss_grads(params, cfg, batch):
    flat = _flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    im, gb, gc, gv = batch
    loss = tdet.detector_loss(params, cfg, torch.from_numpy(im), torch.from_numpy(gb),
                              torch.from_numpy(gc).long(), torch.from_numpy(gv))
    return loss, dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def test_detector_loss_and_gradients_match_jax(det):
    batch = _batch(np.random.default_rng(5), 2, det["jcfg"])
    params = detector_params_from_jax(det["nparams"], det["tcfg"], "cpu")
    loss, grads = _port_loss_grads(params, det["tcfg"], batch)
    jl, jg = det["loss_grad"](det["nparams"], *map(jnp.asarray, batch))
    _rel_close(loss.item(), float(jl), 1e-4)
    ref = _flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert set(ref) == set(grads)
    top = max(np.abs(r).max() for r in ref.values())
    for k, g in grads.items():
        _rel_close(g.numpy(), ref[k], 1e-4, scale=max(np.abs(ref[k]).max(), top * 1e-2)
                   if np.abs(ref[k]).max() > 1e-5 * top else top)


def test_detector_loss_solves_every_head_in_one_call(det, monkeypatch):
    calls = []
    real = tdet.lap_rectangular
    monkeypatch.setattr(tdet, "lap_rectangular", lambda c: calls.append(c.shape) or real(c))
    params = detector_params_from_jax(det["nparams"], det["tcfg"], "cpu")
    _port_loss_grads(params, det["tcfg"], _batch(np.random.default_rng(6), 2, det["jcfg"]))
    cfg = det["tcfg"]
    assert calls == [(2 * (cfg.dec_layers + 1), cfg.max_gt, cfg.num_queries)]


def test_train_detector_matches_optax(det):
    """Three steps of ``train_detector`` against the JAX loss under
    ``chain(clip_by_global_norm(0.1), adamw(cosine_decay_schedule))`` over
    the same batches (drawn by the same numpy generator): the losses of
    every step within 1e-4 relative."""
    jcfg, tcfg = det["jcfg"], det["tcfg"]
    rng = np.random.default_rng(7)
    cases = [tuple(a[0] for a in _batch(rng, 1, jcfg)) for _ in range(5)]
    steps, batch, lr = 3, 2, 1e-3
    res = train_detector(tcfg, cases, steps=steps, batch=batch, lr=lr, seed=0, log_every=100,
                         eval_frac=0, device="cpu",
                         params=detector_params_from_jax(det["nparams"], tcfg, "cpu"),
                         log=lambda m: None)
    tx = optax.chain(optax.clip_by_global_norm(0.1),
                     optax.adamw(optax.cosine_decay_schedule(lr, steps), weight_decay=1e-4))
    params = jax.tree_util.tree_map(jnp.asarray, det["nparams"])
    opt_state = tx.init(params)

    @_jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    draw = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        idx = draw.integers(0, len(cases), batch)
        b = [jnp.asarray(np.stack([cases[i][j] for i in idx])) for j in range(4)]
        loss, grads = det["loss_grad"](params, *b)
        params, opt_state = update(grads, opt_state, params)
        losses.append(float(loss))
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
    assert res["map"] is None


@pytest.mark.parametrize("form", ["detector", "seg_exp"])
def test_adamw_forms_match_optax(form):
    """``OptimizerConfig(form="plain_adamw_cosine")``, with
    ``grad_clip_norm`` 0.1 (the detector) or None (seg-exp), against optax
    over four steps of seeded gradients, every leaf within 1e-6 relative."""
    rng = np.random.default_rng(8)
    tree = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)}],
            "scale": np.ones(4, np.float32)}
    steps, lr, wd = 4, 1e-2, 5e-2
    if form == "detector":
        opt, wd = detector_optimizer(lr, steps), 1e-4
        tx = optax.chain(optax.clip_by_global_norm(0.1),
                         optax.adamw(optax.cosine_decay_schedule(lr, steps), weight_decay=wd))
    else:
        opt = AdamW(OptimizerConfig(lr=lr, weight_decay=wd, max_steps=steps, grad_clip_norm=None,
                                    form="plain_adamw_cosine"))
        tx = optax.adamw(optax.cosine_decay_schedule(lr, steps), weight_decay=wd)
    flat = {k: torch.from_numpy(v.copy()) for k, v in _flatten(tree).items()}
    state = opt.init(flat)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = tx.init(jp)

    @_jit
    def update(g, js, jp):
        upd, js = tx.update(g, js, jp)
        return optax.apply_updates(jp, upd), js

    for _ in range(steps):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        opt.step(flat, {k: torch.from_numpy(v) for k, v in _flatten(g).items()}, state)
        jp, js = update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    for k, v in _flatten(jax.tree_util.tree_map(np.asarray, jp)).items():
        np.testing.assert_allclose(flat[k].numpy(), v, rtol=1e-6, atol=1e-7)


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(9)
    q, c = 30, len(tdet.VINDR_CLASSES)
    logits = rng.normal(-3, 2, (q, c)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 1, (q, 2)), rng.uniform(0.01, 0.6, (q, 2))],
                           -1).astype(np.float32)
    tagged = ["cardiomegaly", "lung nodule", "pleural effusion", "not a class"]
    for th in (0.1, 0.5, 0.99):
        assert (tdet.select_boxes(logits, boxes, tagged, (300, 420), score_th=th)
                == jdet.select_boxes(logits, boxes, tagged, (300, 420), score_th=th))
    for img in ((rng.beta(2, 5, (32, 48)) * 255).astype(np.uint8),
                rng.normal(100, 30, (20, 30)).astype(np.float32), np.full((4, 4), 7, np.uint8)):
        np.testing.assert_array_equal(tdet.equalize_image(img), jdet.equalize_image(img))
    dets, gts = [], []
    for _ in range(4):
        n, m = rng.integers(1, 8), rng.integers(1, 5)
        xy = rng.uniform(0, 80, (n, 2))
        dets.append({"boxes": np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], -1),
                     "scores": rng.random(n), "classes": rng.integers(0, 3, n)})
        xy = rng.uniform(0, 80, (m, 2))
        gts.append({"boxes": np.concatenate([xy, xy + rng.uniform(5, 30, (m, 2))], -1),
                    "classes": rng.integers(0, 3, m)})
    assert tdet.compute_map(dets, gts, 3) == jdet.compute_map(dets, gts, 3)


def test_detector_params_round_trip_and_checks(det):
    params = detector_params_from_jax(det["nparams"], det["tcfg"], "cpu")
    assert params["encoder"][0]["attn"]["offsets"]["b"].shape == (4 * 3 * 2 * 2,)
    bad = dict(det["nparams"], extra=np.zeros(1))
    with pytest.raises(ValueError, match="not consumed"):
        detector_params_from_jax(bad, det["tcfg"], "cpu")
    bad = {k: v for k, v in det["nparams"].items() if k != "class_head"}
    with pytest.raises(ValueError, match="left unset"):
        detector_params_from_jax(bad, det["tcfg"], "cpu")
    bad = dict(det["nparams"], level_embed=np.zeros((2, 32), np.float32))
    with pytest.raises(ValueError, match="shape"):
        detector_params_from_jax(bad, det["tcfg"], "cpu")
    # the port's init has the JAX init's tree, shapes and fixed leaves
    init = tdet.init_detector_params(det["tcfg"], seed=0, device="cpu")
    ref = _flatten(det["nparams"])
    got = _flatten(init)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    for k in ("encoder/0/attn/offsets/b", "class_head/b", "backbone/stem_gn/scale"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6)
