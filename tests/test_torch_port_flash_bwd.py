"""K7, the flash attention backward: its plain version against the JAX
Pallas backward (``mmmm_tpu.ops.flash._flash_bwd_impl`` and ``jax.vjp`` of
``flash_segment_attention``, interpret mode on the CPU), the autograd
Function against ``torch.autograd.gradcheck`` and against autograd of the
plain ``"xla"`` attention, and the ``segment_attention`` dispatch.

Inputs: B=2, S=160 (the reference pads to 128-row blocks, so its tail block
is partial), H=2, two packed segments in sample 0, a padded tail in sample
1 and a query row of sample 0 whose segment has no key (its gradients are
zero). Tolerances: 1e-4 of the largest magnitude of each reference output
in fp32, 2e-2 of it in bf16 (p and ds are rounded to bf16 before their
products on both sides, at rows that may round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import attention as jatt
from mmmm_tpu.ops import flash as jflash
from mmmm_tpu_torch.ops import attention as patt
from mmmm_tpu_torch.ops import dense_attn as pdense
from mmmm_tpu_torch.ops import flash as pflash

B, S, H = 2, 160, 2


def _inputs(d: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, S, H, d)).astype(np.float32) for _ in range(4))
    seg = np.zeros((B, S), np.int32)
    seg[0, :90], seg[0, 90:] = 1, 2  # two packed segments
    seg[1, :131] = 1  # padded tail
    kv_seg = seg.copy()
    kv_seg[0, 90:95] = 3  # query row 90 of sample 0 (segment 2) sees no key when causal
    if dtype == "bfloat16":
        q, k, v, g = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, g))
        q, k, v, g = (np.asarray(t) for t in (q, k, v, g))
    return q, k, v, g, seg, kv_seg


def _torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, ref, frac):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=frac * np.abs(ref).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", [(64, "float32"), (88, "bfloat16"), (128, "bfloat16")])
def test_bwd_plain_matches_pallas(d, dtype, causal):
    q, k, v, g, seg, kv_seg = _inputs(d, dtype)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    jseg, jkv = jnp.asarray(seg), jnp.asarray(kv_seg)
    out, lse = jflash._flash_fwd_impl(jq, jk, jv, jseg, jkv, causal, scale, 128, 128)
    ref = jflash._flash_bwd_impl(jq, jk, jv, jseg, jkv, out, lse, jg, causal, scale, 128, 128)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_segment_attention(
        a, b, c, jseg, jkv, causal=causal, scale=scale), jq, jk, jv)
    ref_vjp = vjp(jg)
    pq, pk, pv, pg = (_torch(t) for t in (q, k, v, g))
    pseg, pkv = torch.from_numpy(seg), torch.from_numpy(kv_seg)
    pout, plse = pflash.flash_segment_attention(pq, pk, pv, pseg, pkv, causal=causal,
                                                scale=scale)
    got = pflash.flash_segment_attention_bwd_plain(pq, pk, pv, pseg, pkv, pout, plse, pg,
                                                   causal=causal, scale=scale)
    frac = 1e-4 if dtype == "float32" else 2e-2
    for a, r, rv in zip(got, ref, ref_vjp):
        assert a.dtype == pq.dtype
        _close(a, r, frac)
        _close(a, rv, frac)
    if causal:  # the row with no key, and the padded tail, get zero gradients
        assert torch.all(got[0][0, 90] == 0) and torch.all(got[0][1, 131:] == 0)
        assert torch.all(got[1][1, 131:] == 0) and torch.all(got[2][1, 131:] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradcheck(causal):
    """float64 on the plain route: the Function's forward and backward are the
    plain versions, so gradcheck holds its backward against finite
    differences."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(1, 9, 2, 4)), requires_grad=True)
               for _ in range(3))
    seg = torch.tensor([[1, 1, 1, 1, 2, 2, 2, 0, 0]], dtype=torch.int32)
    kv_seg = seg.clone()
    kv_seg[0, 4] = 3  # query 4 has no key when causal

    def fn(a, b, c):
        return pflash.flash_attention(a, b, c, seg, kv_seg, causal=causal, scale=0.5)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,all_valid", [(True, False), (False, False), (False, True)])
def test_pallas_route_matches_xla_autograd(causal, all_valid):
    """``segment_attention(impl="pallas")`` (the Function) against autograd of
    ``impl="xla"`` (the plain masked attention, row max detached), fp32;
    and ``impl="xla"`` against ``jax.vjp`` of the reference's xla route."""
    q, k, v, g, seg, kv_seg = _inputs(16, "float32", seed=2)
    if all_valid:
        seg = kv_seg = np.ones_like(seg)
    grads = {}
    for impl in ("pallas", "xla"):
        pq, pk, pv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        out = patt.segment_attention(pq, pk, pv, torch.from_numpy(seg), torch.from_numpy(kv_seg),
                                     causal=causal, impl=impl, all_valid=all_valid)
        grads[impl] = torch.autograd.grad(out, (pq, pk, pv), torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: jatt.segment_attention(
        a, b, c, jnp.asarray(seg), jnp.asarray(kv_seg), causal=causal, impl="xla",
        all_valid=all_valid), *(jnp.asarray(t) for t in (q, k, v)))
    for a, b, r in zip(grads["pallas"], grads["xla"], vjp(jnp.asarray(g))):
        _close(a, b.numpy(), 1e-4)
        _close(b, r, 1e-4)


def test_dense_site_and_dispatch():
    """The dense site (K4 forward, plain recompute backward) has the plain
    dense attention's gradients; ``"auto"`` on the CPU is the plain route
    (the reference's ``"auto"`` off the TPU); ``"ring"`` is ``"auto"`` at
    this layer (the ring is ``parallel/ring_attention.py attention``'s);
    ``fits_dense_kernel`` is the reference's gate."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(size=(2, 33, 2, 8)).astype(np.float32) for _ in range(4))
    got, ref = [], []
    for fn, out in ((pdense.dense_attention_site, got), (pdense.dense_attention_plain, ref)):
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out.extend(torch.autograd.grad(fn(*t, 0.3), t, torch.from_numpy(g)))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    seg = torch.ones(2, 33, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    torch.testing.assert_close(patt.segment_attention(tq, tk, tv, seg, impl="auto"),
                               patt.segment_attention(tq, tk, tv, seg, impl="xla"))
    torch.testing.assert_close(patt.segment_attention(tq, tk, tv, seg, impl="ring"),
                               patt.segment_attention(tq, tk, tv, seg, impl="auto"),
                               rtol=0, atol=0)
    from mmmm_tpu.ops.dense_attn import fits_dense_kernel

    for s, d in ((1153, 112), (577, 112), (512, 64), (4097, 128), (9000, 128)):
        assert pdense.fits_dense_kernel(s, d) == fits_dense_kernel(s, d)
