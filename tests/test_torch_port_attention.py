"""The port's attention kernels (K1-K4): each plain version against the JAX
package's Pallas kernel, run in interpret mode as it runs on the CPU.

fp32 cases agree to atol 2e-5; one bf16 case per kernel to atol 0.05, the
repo's bf16 attention tolerance; K2 (a copy) is bit-equal. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import attention as jatt
from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu.ops import dense_attn as jdense
from mmmm_tpu.ops import flash as jflash
from mmmm_tpu_torch.ops import attention as patt
from mmmm_tpu_torch.ops import decode_kernel as pdec
from mmmm_tpu_torch.ops import dense_attn as pdense
from mmmm_tpu_torch.ops import flash as pflash

FP32 = dict(atol=2e-5, rtol=0)
BF16 = dict(atol=0.05, rtol=0)


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


# ---- K4: dense attention -----------------------------------------------------

@pytest.mark.parametrize("d,bf16", [(88, False), (112, False), (64, False), (112, True)])
def test_dense_attention_plain_matches_pallas(d, bf16):
    rng = np.random.default_rng(d)
    b, s, h = 1, 70, 2  # S is not a multiple of the kernel's 128-row blocks
    (jq, pq), (jk, pk), (jv, pv) = (_both(_rand(rng, (b, s, h, d), bf16), bf16) for _ in range(3))
    scale = d ** -0.5
    ref = jdense.dense_attention(jq, jk, jv, scale)
    got = pdense.dense_attention(pq, pk, pv, scale)
    assert got.dtype == pq.dtype and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), _np(ref), **(BF16 if bf16 else FP32))


# ---- K3: flash forward ---------------------------------------------------------

def _flash_inputs(rng, bf16):
    b, s, h, d = 2, 40, 2, 16
    q, k, v = (_rand(rng, (b, s, h, d), bf16) for _ in range(3))
    lens = np.array([40, 29])
    q_seg = (np.arange(s)[None] < lens[:, None]).astype(np.int32)  # right-padded rows
    kv_seg = q_seg.copy()
    kv_seg[0, :3] = 2  # query rows 0..2 of sample 0 see no key of their segment
    return q, k, v, q_seg, kv_seg


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_plain_matches_pallas(bf16):
    rng = np.random.default_rng(7)
    q, k, v, q_seg, kv_seg = _flash_inputs(rng, bf16)
    (jq, pq), (jk, pk), (jv, pv) = (_both(t, bf16) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    ref = jflash.flash_segment_attention(jq, jk, jv, jnp.asarray(q_seg), jnp.asarray(kv_seg),
                                         causal=True, scale=scale)
    _, ref_lse = jflash._flash_fwd_impl(jq, jk, jv, jnp.asarray(q_seg), jnp.asarray(kv_seg),
                                        True, scale, 128, 128)
    out, lse = pflash.flash_segment_attention(pq, pk, pv, torch.from_numpy(q_seg),
                                              torch.from_numpy(kv_seg), causal=True,
                                              scale=scale)
    tol = BF16 if bf16 else FP32
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0, : q.shape[1]],
                               atol=1e-4 if bf16 else 2e-5)
    # fully masked rows: zero output and zero lse, never NaN
    assert torch.all(out[0, :3] == 0) and torch.all(lse[0, :, :3] == 0)
    assert torch.all(out[1, 29:] == 0) and torch.all(lse[1, :, 29:] == 0)


def test_segment_attention_matches_xla():
    rng = np.random.default_rng(8)
    q, k, v, q_seg, kv_seg = _flash_inputs(rng, False)
    for causal in (False, True):
        ref = jatt.segment_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(q_seg), jnp.asarray(kv_seg), causal=causal,
                                     impl="xla")
        got = patt.segment_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(q_seg),
                                     torch.from_numpy(kv_seg), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)


# ---- K1: decode attention ----------------------------------------------------

def _decode_inputs(rng, bf16):
    b, h, smax, d = 3, 2, 24, 16
    q = _rand(rng, (b, 1, h, d), bf16)
    kc, vc = (_rand(rng, (b, h, smax, d), bf16) for _ in range(2))
    kv_len = np.array([1, 13, smax], np.int32)
    return q, kc, vc, kv_len


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_plain_matches_pallas(bf16):
    rng = np.random.default_rng(9)
    q, kc, vc, kv_len = _decode_inputs(rng, bf16)
    (jq, pq), (jk, pk), (jv, pv) = (_both(t, bf16) for t in (q, kc, vc))
    scale = q.shape[-1] ** -0.5
    got = pdec.decode_attention(pq, pk, pv, torch.from_numpy(kv_len))
    assert got.dtype == pq.dtype and got.shape == q.shape
    full = jdec._decode_attention_pallas_full(jq, jk, jv, jnp.asarray(kv_len), scale=scale)
    ragged = jdec.decode_attention_pallas_ragged(jq, jk, jv, jnp.asarray(kv_len), block_s=8)
    tol = BF16 if bf16 else FP32
    np.testing.assert_allclose(_np(got), _np(full), **tol)
    np.testing.assert_allclose(_np(got), _np(ragged), **tol)


def test_decode_attention_bhsd_matches_xla():
    rng = np.random.default_rng(10)
    q, kc, vc, kv_len = _decode_inputs(rng, False)
    valid = np.arange(kc.shape[2])[None] < kv_len[:, None]
    ref = jatt.decode_attention_bhsd(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(valid))
    got = patt.decode_attention_bhsd(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)
    plain = pdec.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(kc),
                                        torch.from_numpy(vc), torch.from_numpy(kv_len))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **FP32)


# ---- K2: KV append --------------------------------------------------------------

@pytest.mark.parametrize("widx", [[0, 7, 23], [23, 23, 5], [30, -2, 11]])
def test_kv_append_plain_bit_equal(widx):
    """Includes the last slot and indices past either end, which the
    reference's dynamic_update_slice clamps."""
    rng = np.random.default_rng(11)
    b, h, smax, d = 3, 2, 24, 16
    kc, vc = (_rand(rng, (b, h, smax, d), True) for _ in range(2))
    kn, vn = (_rand(rng, (b, h, 1, d), True) for _ in range(2))
    w = np.asarray(widx, np.int32)
    jk, jv = jdec.kv_append_pallas(*(jnp.asarray(t, jnp.bfloat16) for t in (kc, vc, kn, vn)),
                                   jnp.asarray(w))
    pk, pv = (torch.from_numpy(t).to(torch.bfloat16) for t in (kc, vc))
    out_k, out_v = pdec.kv_append(pk, pv, *(torch.from_numpy(t).to(torch.bfloat16)
                                            for t in (kn, vn)), torch.from_numpy(w))
    assert out_k is pk and out_v is pv  # in place
    np.testing.assert_array_equal(pk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(pv.float().numpy(), np.asarray(jv, np.float32))


# ---- routing of the wrappers -----------------------------------------------------

def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; any device
    other than the CPU or CUDA is refused, never computed."""
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pdense.dense_attention(q, q, q, 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        pdec.decode_attention(torch.zeros(1, 1, 1, 8, device="meta"), q, q,
                              torch.zeros(1, dtype=torch.int32, device="meta"))
