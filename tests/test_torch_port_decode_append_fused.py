"""The fused forms of the decode step's reads over K9, K10 and K6:
``decode_attention_q8_append`` (``quantize_kv`` of the new row and K8's
append inside K9's or K10's launch) and ``decode_attention_window_append``
(K5's append inside K6's launch).

On the CPU each fused wrapper runs its plain version; here it is held against
the JAX package's sequence, run as the JAX package's own tests run it:
``quant.quantize_kv``, ``kv_append_pallas_q8`` (its CPU form, the vmapped
``dynamic_update_slice``), then ``decode_attention_pallas_q8`` or
``decode_attention_pallas_q8_mxu`` in interpret mode; ``kv_append_pallas_multi``
(interpret mode where the window lies in the cache, its CPU form where it
shifts) then ``decode_attention_pallas_window`` in interpret mode. The caches
bit-equal, the outputs to this file's tolerances (fp32 2e-5; bf16 0.05, the
repo's bf16 attention tolerance). The CUDA kernels are held against these
plain versions on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.

The decode step through ``generate_grounded(device="cpu")`` takes these
routes and is held to the JAX package's tokens by
tests/test_torch_port_spec.py ``test_generate_grounded_w8a16_matches_jax``
(greedy over an int8 cache: K9's route; speculative over a bf16 cache: K6's)
and tests/test_torch_port_capacity.py
``test_generate_grounded_w4_split_int8_matches_jax`` (K10's route).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu.ops import quant as jquant
from mmmm_tpu_torch.ops import decode_kernel as pdec
from mmmm_tpu_torch.ops.quant import quantize_kv

FP32 = dict(atol=2e-5, rtol=0)
BF16 = dict(atol=0.05, rtol=0)
B, H, SMAX = 3, 2, 24


def _rand(rng, shape, bf16):
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else x


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _t(a):
    """A writable torch copy of a JAX array, bf16 included."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _q8_cache(rng, d):
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(B, H, SMAX, d)), jnp.bfloat16))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(B, H, SMAX, d)), jnp.bfloat16))
    return {"kq": kq, "ks": ks, "vq": vq, "vs": vs}


# (write_index, kv_len): the decode step's t = kv_len - 1; t >= kv_len (written,
# not read); a negative index (from the end) and one past Smax (the last slot)
WIDX_LENS = [([4, 17, 23], [5, 18, 24]), ([9, 20, 0], [3, 11, 0]),
             ([-1, 30, -30], [24, 24, 7])]


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("widx,kv_len", WIDX_LENS)
@pytest.mark.parametrize("d", [16, 90, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_q8_append_plain_matches_pallas(bf16, d, widx, kv_len, mxu):
    """The int8 step: JAX's quantize_kv of the new rows, its append, then
    its K9 (or, ``mxu``, K10) read, against the fused wrapper on the CPU."""
    rng = np.random.default_rng(d + 7 * widx[0] + mxu)
    q = _rand(rng, (B, 1, H, d), bf16)
    kn, vn = (_rand(rng, (B, 1, H, d), bf16) for _ in range(2))
    cache = _q8_cache(rng, d)
    w, n = np.asarray(widx, np.int32), np.asarray(kv_len, np.int32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    new = [*jquant.quantize_kv(jnp.swapaxes(jnp.asarray(kn, jdt), 1, 2)),
           *jquant.quantize_kv(jnp.swapaxes(jnp.asarray(vn, jdt), 1, 2))]
    want_cache = jdec.kv_append_pallas_q8(cache, *new, jnp.asarray(w))
    leaves = [want_cache[k] for k in pdec.Q8_LEAVES]
    read = jdec.decode_attention_pallas_q8_mxu if mxu else jdec._decode_attention_pallas_q8_full
    want = read(jnp.asarray(q, jdt), *leaves, jnp.asarray(n), scale=d ** -0.5)
    assert pdec._q8_mxu_eligible(H, SMAX, d)

    got_cache = {k: _t(v) for k, v in cache.items()}
    got = pdec.decode_attention_q8_append(
        torch.from_numpy(q).to(tdt), got_cache, *(torch.from_numpy(t).to(tdt) for t in (kn, vn)),
        torch.from_numpy(w), torch.from_numpy(n), q8_mxu=mxu)
    assert got.dtype == tdt and got.shape == q.shape
    for key in pdec.Q8_LEAVES:  # in place, bit for bit
        np.testing.assert_array_equal(_np(got_cache[key]), _np(want_cache[key]), err_msg=key)
    np.testing.assert_allclose(_np(got), _np(want), **(BF16 if bf16 else FP32))
    assert np.all(_np(got)[n == 0] == 0)


# (write_index, window): in the middle; near Smax, where the window shifts
# back whole; negative (from the end, the mask still from the raw index)
WINDOW_WIDX = {"mid": lambda k: [3, 9, 12], "near_smax": lambda k: [SMAX - k, SMAX - 1, 22],
               "negative": lambda k: [-1, -k - 2, 5]}


@pytest.mark.parametrize("case", sorted(WINDOW_WIDX))
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_window_append_plain_matches_pallas(bf16, k, case):
    """The verify step: JAX's window append (rows at the clamped start) then
    its K6 read (masked by the raw write_index), against the fused wrapper."""
    rng = np.random.default_rng(31 * k + len(case))
    d = 16
    widx = WINDOW_WIDX[case](k)
    q = _rand(rng, (B, k, H, d), bf16)
    kc, vc = (_rand(rng, (B, H, SMAX, d), bf16) for _ in range(2))
    kn, vn = (_rand(rng, (B, k, H, d), bf16) for _ in range(2))
    w = np.asarray(widx, np.int32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    in_cache = all(0 <= t <= SMAX - k for t in widx)
    jk, jv = jdec.kv_append_pallas_multi(
        *(jnp.asarray(t, jdt) for t in (kc, vc)),
        *(jnp.swapaxes(jnp.asarray(t, jdt), 1, 2) for t in (kn, vn)), jnp.asarray(w),
        interpret=in_cache)
    want = jdec.decode_attention_pallas_window(jnp.asarray(q, jdt), jk, jv, jnp.asarray(w))

    pk, pv = (torch.from_numpy(t).to(tdt) for t in (kc, vc))
    got = pdec.decode_attention_window_append(
        torch.from_numpy(q).to(tdt), pk, pv, *(torch.from_numpy(t).to(tdt) for t in (kn, vn)),
        torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_array_equal(_np(pk), _np(jk))  # in place
    np.testing.assert_array_equal(_np(pv), _np(jv))
    np.testing.assert_allclose(_np(got), _np(want), **(BF16 if bf16 else FP32))


@pytest.mark.parametrize("form", ["q8", "q8_mxu", "window"])
def test_fused_wrappers_equal_the_sequence(form):
    """Each fused wrapper gives what its sequence gives, bit for bit, caches
    and output: ``quantize_kv`` twice, ``kv_append_q8`` and
    ``decode_attention_q8``; ``kv_append_multi`` and
    ``decode_attention_window``; over new rows that are a strided view."""
    g = torch.Generator().manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g).to(torch.bfloat16)
    d, k = 32, (3 if form == "window" else 1)
    qkv = rnd(B, k, 3 * H, d)  # a fused projection: q, k and v are views of it
    q, kn, vn = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    w = torch.tensor([5, -1, 30], dtype=torch.int32)
    if form == "window":
        kc, vc = rnd(B, H, SMAX, d), rnd(B, H, SMAX, d)
        ka, va = kc.clone(), vc.clone()
        pdec.kv_append_multi(ka, va, kn.transpose(1, 2), vn.transpose(1, 2), w)
        want = pdec.decode_attention_window(q, ka, va, w)
        got = pdec.decode_attention_window_append(q, kc, vc, kn, vn, w)
        assert torch.equal(kc, ka) and torch.equal(vc, va) and torch.equal(got, want)
        return
    mxu = form == "q8_mxu"
    kv_len = torch.tensor([6, 24, 0], dtype=torch.int32)
    kq, ks = quantize_kv(rnd(B, H, SMAX, d))
    vq, vs = quantize_kv(rnd(B, H, SMAX, d))
    cache = {"kq": kq, "ks": ks, "vq": vq, "vs": vs}
    ref = {key: t.clone() for key, t in cache.items()}
    pdec.kv_append_q8(ref, *quantize_kv(kn.transpose(1, 2)), *quantize_kv(vn.transpose(1, 2)), w)
    want = pdec.decode_attention_q8(q, *(ref[key] for key in pdec.Q8_LEAVES), kv_len,
                                    q8_mxu=mxu)
    got = pdec.decode_attention_q8_append(q, cache, kn, vn, w, kv_len, q8_mxu=mxu)
    assert all(torch.equal(cache[key], ref[key]) for key in pdec.Q8_LEAVES)
    assert torch.equal(got, want)
