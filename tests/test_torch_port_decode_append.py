"""K1's fused form (``decode_attention_append``: K2's append inside K1's
launch), the decode step's route over a bf16 or fp32 cache, and K1's split
of a head's slots over a cluster's blocks.

On the CPU the fused wrapper runs its plain version; here it is held against
the JAX package's K2 (``kv_append_pallas``) followed by K1 in both of its TPU
forms (``_decode_attention_pallas_full``, ``decode_attention_pallas_ragged``),
run in interpret mode as the JAX package's tests run them: the caches
bit-equal, the output to this file's tolerances (fp32 2e-5; bf16 0.05, the
repo's bf16 attention tolerance). The CUDA kernel is held against the plain
version on the card by tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu_torch.ops import decode_kernel as pdec

FP32 = dict(atol=2e-5, rtol=0)
BF16 = dict(atol=0.05, rtol=0)
B, H, SMAX, D = 3, 2, 24, 16


def _rand(rng, shape, bf16):
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else x


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# (write_index, kv_len): the decode step's t = kv_len - 1; t >= kv_len; a
# negative index (from the end) and one past Smax (clamped to the last slot)
@pytest.mark.parametrize("widx,kv_len", [([4, 17, 23], [5, 18, 24]),
                                         ([9, 20, 0], [3, 11, 0]),
                                         ([-1, 30, -30], [24, 24, 7])])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_append_plain_matches_pallas(bf16, widx, kv_len):
    rng = np.random.default_rng(90 + len(widx) + widx[0])
    q = _rand(rng, (B, 1, H, D), bf16)
    kc, vc = (_rand(rng, (B, H, SMAX, D), bf16) for _ in range(2))
    kn, vn = (_rand(rng, (B, H, 1, D), bf16) for _ in range(2))
    w, n = np.asarray(widx, np.int32), np.asarray(kv_len, np.int32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jk, jv = jdec.kv_append_pallas(*(jnp.asarray(t, jdt) for t in (kc, vc, kn, vn)),
                                   jnp.asarray(w))
    jq = jnp.asarray(q, jdt)
    full = jdec._decode_attention_pallas_full(jq, jk, jv, jnp.asarray(n), scale=D ** -0.5)
    ragged = jdec.decode_attention_pallas_ragged(jq, jk, jv, jnp.asarray(n), block_s=8)

    pk, pv = (torch.from_numpy(t).to(tdt) for t in (kc, vc))
    got = pdec.decode_attention_append(
        torch.from_numpy(q).to(tdt), pk, pv, *(torch.from_numpy(t).to(tdt) for t in (kn, vn)),
        torch.from_numpy(w), torch.from_numpy(n))
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_array_equal(_np(pk), np.asarray(jk, np.float32))  # in place
    np.testing.assert_array_equal(_np(pv), np.asarray(jv, np.float32))
    tol = BF16 if bf16 else FP32
    np.testing.assert_allclose(_np(got), _np(full), **tol)
    np.testing.assert_allclose(_np(got), _np(ragged), **tol)
    assert np.all(_np(got)[n == 0] == 0)


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_append_equals_append_then_read(bf16):
    """The fused wrapper gives what ``kv_append`` then ``decode_attention``
    give, bit for bit, caches and output."""
    rng = np.random.default_rng(7)
    tdt = torch.bfloat16 if bf16 else torch.float32
    q, kn, vn = (torch.from_numpy(_rand(rng, s, bf16)).to(tdt)
                 for s in ((B, 1, H, D), (B, H, 1, D), (B, H, 1, D)))
    kc, vc = (torch.from_numpy(_rand(rng, (B, H, SMAX, D), bf16)).to(tdt) for _ in range(2))
    w = torch.tensor([3, -2, 40], dtype=torch.int32)
    n = torch.tensor([4, 24, 13], dtype=torch.int32)
    ka, va = kc.clone(), vc.clone()
    pdec.kv_append(ka, va, kn, vn, w)
    ref = pdec.decode_attention(q, ka, va, n)
    got = pdec.decode_attention_append(q, kc, vc, kn, vn, w, n)
    assert torch.equal(kc, ka) and torch.equal(vc, va) and torch.equal(got, ref)


H100_SMS = 132  # the flagship's card


@pytest.mark.parametrize("b", [4, 2, 1])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("d_lo", [1, 33, 65, 97])
def test_decode_plan_fits_the_card(b, elem, d_lo):
    """For every head dim in [d_lo, d_lo + 32), bf16 and fp32, at H = 32
    (the flagship's heads) and B = 4, 2 and 1, over Smax 1-9000 (every 7th
    and each one near a ring's edge): at most 8 splits, no more than leave
    32 slots of a full cache to a split, and the plan's dynamic shared
    memory (the kernel's own count, ``decode_block_smem``) plus K1's static
    allowance within the H100's 227 KiB."""
    h = 32
    smaxes = sorted({*range(1, 9001, 7), *range(420, 440), *range(1270, 1300),
                     *range(2115, 2165), 8192})
    for d in range(d_lo, d_lo + 32):
        for smax in smaxes:
            s = pdec.decode_splits(b, h, smax, H100_SMS)
            assert 1 <= s <= pdec.DECODE_MAX_SPLITS
            assert s == 1 or smax // s >= pdec.DECODE_SPLIT_SLOTS
            chunk, stages = pdec.decode_stage_plan(smax, s, d, elem)
            dyn = pdec.decode_block_smem(chunk, stages, d, elem, s)
            assert dyn + pdec.K1_STATIC_SMEM <= 232448, (b, elem, d, smax, chunk, stages)


def test_decode_splits_fill_the_card_at_the_flagship():
    """Run (a)'s cache (Smax 320, H = 32) on the H100's 132 SMs: one block a
    head at B = 4 (128 heads cover 7/8 of the SMs), 5 splits at B = 1 (160
    blocks, at least one on every SM); 2,048 heads take one block each; a
    card with fewer SMs splits less."""
    assert pdec.decode_splits(4, 32, 320, H100_SMS) == 1
    assert pdec.decode_splits(1, 32, 320, H100_SMS) == 5
    assert pdec.decode_splits(1, 32, 320, H100_SMS) * 32 >= H100_SMS
    assert pdec.decode_splits(64, 32, 320, H100_SMS) == 1
    assert pdec.decode_splits(1, 1, 40, H100_SMS) == 1  # a split keeps 32 slots of a full cache
    assert pdec.decode_splits(1, 32, 320, 64) == 2
    assert pdec.decode_splits(4, 32, 320, 114) == 1


@pytest.mark.parametrize("smax,d,elem,b", [(320, 128, 2, 4), (320, 128, 2, 1), (321, 90, 2, 4),
                                           (320, 128, 4, 4), (8192, 128, 2, 2),
                                           (8192, 90, 4, 2), (100000, 8, 2, 1),
                                           (432, 128, 2, 4), (1024, 96, 2, 4)])
def test_decode_stage_plan_fits(smax, d, elem, b):
    """Each of a block's 8 warps reads its share of a split's run whole (K
    and V one stage each) where the block fits in K1's dynamic shared memory
    budget, else through a ring of 4 stages of the most slots that fit; the
    flagship's bf16 decode (B = 4) takes the whole read, 40 slots a warp,
    and its fp32 form the ring. The budget leaves room for K1's static
    arrays within the H100's 227 KiB."""
    assert pdec.K1_DYNAMIC_SMEM + pdec.K1_STATIC_SMEM == 232448
    h = 32 if smax < 2000 else 8
    splits = pdec.decode_splits(b, h, smax, H100_SMS)
    chunk, stages = pdec.decode_stage_plan(smax, splits, d, elem)
    used = lambda c, ns: pdec.decode_block_smem(c, ns, d, elem, splits)
    assert used(chunk, stages) <= pdec.K1_DYNAMIC_SMEM
    warps = pdec.DECODE_WARPS
    assert used(chunk, stages) >= warps * pdec.decode_stage_bytes(chunk, stages, d, elem)
    per = -(-smax // splits)
    share = -(-per // warps)
    if stages == 2:
        assert chunk == share
    else:
        assert stages == pdec.Q8_RING_STAGES and 1 <= chunk < share
        assert used(chunk + 1, stages) > pdec.K1_DYNAMIC_SMEM
    if (smax, d, elem, b) == (320, 128, 2, 4):
        assert (chunk, stages) == (40, 2)
    if (smax, d, elem, b) == (320, 128, 4, 4):
        assert stages == pdec.Q8_RING_STAGES
