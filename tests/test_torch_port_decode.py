"""The second slice's decode kernels (K5, K6, K8, K9): each plain version
against the JAX package's Pallas kernel, run in interpret mode as it runs on
the CPU, and against the reference's XLA form.

The appends (K5, K8) are bit-equal to the vmapped ``dynamic_update_slice``
the reference runs off the TPU, edges included. The attention reads agree to
atol 1e-5 in fp32 and 2e-2 in bf16. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_port_cuda.py
and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import attention as jatt
from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu.ops import quant as jquant
from mmmm_tpu_torch.ops import decode_kernel as pdec
from mmmm_tpu_torch.ops import quant as pquant

FP32 = dict(atol=1e-5, rtol=0)
BF16 = dict(atol=2e-2, rtol=0)


def _rand(rng, shape, bf16=False):
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else x


def _both(x, bf16=False):
    """The same values as a JAX array and a torch tensor of one dtype."""
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _t(a):
    """A writable torch copy of a JAX array, bf16 included."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_dus = jax.vmap(lambda c, u, i: jax.lax.dynamic_update_slice_in_dim(c, u, i, axis=1))


# ---- K5: verify-window append ------------------------------------------------------

@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("widx", [[8, 13, 40], [0, 47, 3], [-1, -50, 44], [100, -8, 41]])
def test_kv_append_multi_plain_bit_equal(bf16, widx):
    """Rows 8 (aligned), 13 (spills into the next 8-slot block) and 40 (ends
    at Smax); then starts past either end and negative ones, which the
    reference's dynamic_update_slice wraps once and clamps (the window
    shifts)."""
    rng = np.random.default_rng(5)
    b, h, smax, d, k = 3, 2, 48, 16, 8
    kc, vc = (_rand(rng, (b, h, smax, d), bf16) for _ in range(2))
    kn, vn = (_rand(rng, (b, h, k, d), bf16) for _ in range(2))
    w = np.asarray(widx, np.int32)
    (jkc, pkc), (jvc, pvc), (jkn, pkn), (jvn, pvn) = (_both(t, bf16) for t in (kc, vc, kn, vn))
    want_k, want_v = _dus(jkc, jkn, jnp.asarray(w)), _dus(jvc, jvn, jnp.asarray(w))
    out_k, out_v = pdec.kv_append_multi(pkc, pvc, pkn, pvn, torch.from_numpy(w))
    assert out_k is pkc and out_v is pvc  # in place
    np.testing.assert_array_equal(_np(pkc), _np(want_k))
    np.testing.assert_array_equal(_np(pvc), _np(want_v))
    if all(0 <= t <= smax - k for t in widx):
        ik, iv = jdec.kv_append_pallas_multi(jkc, jvc, jkn, jvn, jnp.asarray(w), interpret=True)
        np.testing.assert_array_equal(_np(pkc), _np(ik))
        np.testing.assert_array_equal(_np(pvc), _np(iv))


# ---- K6: verify-window attention ---------------------------------------------------

@pytest.mark.parametrize("bf16,nq", [(False, 8), (False, 2), (True, 8), (True, 4)])
def test_decode_attention_window_plain_matches_pallas(bf16, nq):
    rng = np.random.default_rng(7)
    b, h, smax, d = 3, 8, 64, 32
    q = _rand(rng, (b, nq, h, d), bf16)
    kc, vc = (_rand(rng, (b, h, smax, d), bf16) for _ in range(2))
    widx = np.array([0, 37, smax - nq], np.int32)
    (jq, pq), (jk, pk), (jv, pv) = (_both(t, bf16) for t in (q, kc, vc))
    got = pdec.decode_attention_window(pq, pk, pv, torch.from_numpy(widx))
    assert got.dtype == pq.dtype and got.shape == q.shape
    tol = BF16 if bf16 else FP32
    kernel = jdec.decode_attention_pallas_window(jq, jk, jv, jnp.asarray(widx))
    np.testing.assert_allclose(_np(got), _np(kernel), **tol)
    kv_len = widx[:, None] + np.arange(1, nq + 1)[None, :]
    valid = np.arange(smax)[None, None, :] < kv_len[..., None]  # (B, K, Smax)
    xla = jatt.decode_attention_bhsd(jq, jk, jv, jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), _np(xla), **tol)


# ---- K8: int8 append ------------------------------------------------------------------

@pytest.mark.parametrize("widx", [[0, 17, 39], [39, -1, 5], [45, -41, 38]])
def test_kv_append_q8_plain_bit_equal(widx):
    rng = np.random.default_rng(5)
    b, h, smax, d = 3, 4, 40, 8
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    new = [*jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, 1, d)), jnp.bfloat16)),
           *jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, 1, d)), jnp.bfloat16))]
    w = jnp.asarray(widx, jnp.int32)
    want = jdec.kv_append_pallas_q8({"kq": kq, "ks": ks, "vq": vq, "vs": vs}, *new, w)
    cache = {"kq": _t(kq), "ks": _t(ks), "vq": _t(vq), "vs": _t(vs)}
    got = pdec.kv_append_q8(cache, *map(_t, new), _t(w))
    assert got is cache
    for key in pdec.Q8_LEAVES:
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]), err_msg=key)
        np.testing.assert_array_equal(_np(got[key]), _np(_dus(
            {"kq": kq, "ks": ks, "vq": vq, "vs": vs}[key],
            new[pdec.Q8_LEAVES.index(key)], w)), err_msg=key)


# ---- K9: int8 decode attention ----------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_q8_plain_matches_pallas(bf16):
    rng = np.random.default_rng(9)
    b, h, smax, d = 4, 8, 64, 16
    q = _rand(rng, (b, 1, h, d), bf16)
    jq, pq = _both(q, bf16)
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    kv_len = np.array([0, 1, 40, smax], np.int32)
    leaves = [kq, ks, vq, vs]
    got = pdec.decode_attention_q8(pq, *map(_t, leaves), torch.from_numpy(kv_len))
    assert got.dtype == pq.dtype and got.shape == q.shape
    assert torch.all(got[0] == 0)  # kv_len 0 gives zeros
    tol = BF16 if bf16 else FP32
    full = jdec.decode_attention_pallas_q8(jq, *leaves, jnp.asarray(kv_len))
    ragged = jdec.decode_attention_pallas_q8_ragged(jq, *leaves, jnp.asarray(kv_len),
                                                    block_s=32)
    np.testing.assert_allclose(_np(got), _np(full), **tol)
    np.testing.assert_allclose(_np(got), _np(ragged), **tol)
    # and the reference's XLA form over the dequantized cache, where a slot is valid
    valid = np.arange(smax)[None] < kv_len[:, None]
    xla = jatt.decode_attention_bhsd(jnp.asarray(q), jquant.dequantize_kv(kq, ks, jnp.float32),
                                     jquant.dequantize_kv(vq, vs, jnp.float32),
                                     jnp.asarray(valid))
    np.testing.assert_allclose(_np(got)[1:], _np(xla)[1:], **tol)


def test_wrappers_refuse_other_devices():
    """The new wrappers too take their plain version only for CPU tensors."""
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    w = meta(1, dt=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        pdec.kv_append_multi(meta(1, 2, 8, 4), meta(1, 2, 8, 4), meta(1, 2, 2, 4),
                             meta(1, 2, 2, 4), w)
    with pytest.raises(ValueError, match="no kernel"):
        pdec.decode_attention_window(meta(1, 2, 2, 4), meta(1, 2, 8, 4), meta(1, 2, 8, 4), w)
    cache = {"kq": meta(1, 2, 8, 16, dt=torch.int8), "ks": meta(1, 2, 8, 1, dt=torch.bfloat16),
             "vq": meta(1, 2, 8, 16, dt=torch.int8), "vs": meta(1, 2, 8, 1, dt=torch.bfloat16)}
    with pytest.raises(ValueError, match="no kernel"):
        pdec.kv_append_q8(cache, *(cache[k][:, :, :1] for k in pdec.Q8_LEAVES), w)
    with pytest.raises(ValueError, match="no kernel"):
        pdec.decode_attention_q8(meta(1, 1, 2, 16), *(cache[k] for k in pdec.Q8_LEAVES), w)


def test_quantize_kv_matches_jax():
    """``quantize_kv`` bit-equal to the reference's (int8 values and bf16
    scales) on bf16 and fp32 rows, and ``dequantize_kv`` equal."""
    rng = np.random.default_rng(3)
    for bf16 in (True, False):
        x = _rand(rng, (2, 4, 24, 16), bf16) * 3.0
        x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
        jx, px = _both(x, bf16)
        jq, js = jquant.quantize_kv(jx)
        pq, ps = pquant.quantize_kv(px)
        assert pq.dtype == torch.int8 and ps.dtype == torch.bfloat16 and ps.shape == (2, 4, 24, 1)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_np(ps), _np(js))
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_array_equal(_np(pquant.dequantize_kv(pq, ps, dt)),
                                          _np(jquant.dequantize_kv(jq, js, jdt)))
