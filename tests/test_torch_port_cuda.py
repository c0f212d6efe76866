"""The port's CUDA kernels (K1-K6, K8-K11, P1) against their plain PyTorch versions
on the card. Every test is marked ``cuda`` and skips without a GPU.

This file imports neither JAX nor ``mmmm_tpu``, so it also runs where only
PyTorch is installed; tests/conftest.py imports JAX, so on such a machine
run it as ``python3 -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""
import pytest
import torch

from mmmm_tpu_torch.ops import decode_kernel as pdec
from mmmm_tpu_torch.ops import dense_attn as pdense
from mmmm_tpu_torch.ops import flash as pflash
from mmmm_tpu_torch.ops import w4_matmul as pw4
from mmmm_tpu_torch.ops.quant import quantize_int4, quantize_kv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(112, torch.bfloat16), (88, torch.bfloat16),
                                     (64, torch.float32)])
def test_dense_attention_kernel(cuda, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 77, 4, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    got = pdense.dense_attention(q, k, v, d ** -0.5)
    ref = pdense.dense_attention_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2 if dtype == torch.bfloat16
                               else 1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 100, 4, 128, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    seg = (torch.arange(100, device=cuda)[None] < torch.tensor([[100], [61]], device=cuda))
    q_seg = seg.to(torch.int32)
    kv_seg = q_seg.clone()
    kv_seg[0, :3] = 2  # query rows 0..2 of sample 0 see no key of their segment
    out, lse = pflash.flash_segment_attention(q, k, v, q_seg, kv_seg, causal=True,
                                              scale=128 ** -0.5)
    ref, ref_lse = pflash.flash_segment_attention_plain(q, k, v, q_seg, kv_seg, causal=True,
                                                        scale=128 ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.all(out[0, :3] == 0) and torch.all(lse[0, :, :3] == 0)
    assert torch.all(out[1, 61:] == 0) and torch.all(lse[1, :, 61:] == 0)


@pytest.mark.cuda
def test_decode_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, smax, d = 3, 4, 40, 128
    kc, vc = (torch.randn(b, h, smax, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    kn, vn = (torch.randn(b, h, 1, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).bfloat16()
    widx = torch.tensor([0, 20, smax - 1], dtype=torch.int32, device=cuda)
    ref_k, ref_v = pdec.kv_append_plain(kc.clone(), vc.clone(), kn, vn, widx)
    pdec.kv_append(kc, vc, kn, vn, widx)
    assert torch.equal(kc, ref_k) and torch.equal(vc, ref_v)
    kv_len = torch.tensor([1, 21, smax], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention(q, kc, vc, kv_len)
    ref = pdec.decode_attention_plain(q, kc, vc, kv_len)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_kernels(cuda, dtype):
    """K5 bit-equal to its plain version (in range, at Smax, past either end,
    negative); K6 within 2e-2 (bf16) / 1e-4 (fp32) for windows of 2 to 8."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, smax, d = 3, 4, 48, 128
    kc, vc = (torch.randn(b, h, smax, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    for nq, widx in [(8, [0, 13, smax - 8]), (3, [-1, 50, -60]), (2, [7, 0, 46])]:
        kn, vn = (torch.randn(b, h, nq, d, generator=g, device=cuda).to(dtype) for _ in range(2))
        w = torch.tensor(widx, dtype=torch.int32, device=cuda)
        ref_k, ref_v = pdec.kv_append_plain(kc.clone(), vc.clone(), kn, vn, w)
        pdec.kv_append_multi(kc, vc, kn, vn, w)
        assert torch.equal(kc, ref_k) and torch.equal(vc, ref_v)
        q = torch.randn(b, nq, h, d, generator=g, device=cuda).to(dtype)
        got = pdec.decode_attention_window(q, kc, vc, w)
        ref = pdec.decode_attention_window_plain(q, kc, vc, w)
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (16, torch.float32)])
def test_q8_kernels(cuda, d, dtype):
    """K8 bit-equal to its plain version; K9 within 2e-2 (bf16) / 1e-4
    (fp32), kv_len 0 and Smax included."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, smax = 4, 4, 40
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    cache = {"kq": kq, "ks": ks, "vq": vq, "vs": vs}
    new = [*quantize_kv(torch.randn(b, h, 1, d, generator=g, device=cuda)),
           *quantize_kv(torch.randn(b, h, 1, d, generator=g, device=cuda))]
    w = torch.tensor([0, 17, smax - 1, -1], dtype=torch.int32, device=cuda)
    ref = pdec.kv_append_q8_plain({k: v.clone() for k, v in cache.items()}, *new, w)
    pdec.kv_append_q8(cache, *new, w)
    assert all(torch.equal(cache[k], ref[k]) for k in pdec.Q8_LEAVES)
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([0, 1, 23, smax], dtype=torch.int32, device=cuda)
    leaves = [cache[k] for k in pdec.Q8_LEAVES]
    got = pdec.decode_attention_q8(q, *leaves, kv_len)
    want = pdec.decode_attention_q8_plain(q, *leaves, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (16, torch.float32),
                                     (64, torch.float32)])
def test_q8_mxu_kernel(cuda, d, dtype):
    """K10 within 2e-2 (bf16 q) / 1e-4 (fp32 q) of its plain version: the
    integer dots are exact, exp and the softmax sums may move one 14-bit
    weight by a step. kv_len 0 gives zeros."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, smax = 4, 4, 57
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([0, 1, 23, smax], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention_q8_mxu(q, kq, ks, vq, vs, kv_len)
    want = pdec.decode_attention_q8_mxu_plain(q, kq, ks, vq, vs, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
def test_q8_mxu_kernel_wraps_as_int32(cuda):
    """Uniform attention over rows of 127 at kv_len 1100: the int32 sum
    wraps, identically in the kernel and the plain version."""
    b, h, smax, d = 1, 2, 1100, 16
    kq = torch.full((b, h, smax, d), 127, dtype=torch.int8, device=cuda)
    ks = torch.ones((b, h, smax, 1), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((b, 1, h, d), device=cuda)
    kv_len = torch.tensor([smax], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention_q8_mxu(q, kq, ks, kq, ks, kv_len)
    assert torch.equal(got, pdec.decode_attention_q8_mxu_plain(q, kq, ks, kq, ks, kv_len))
    assert torch.all(got < 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,dtype", [(4, torch.bfloat16), (33, torch.bfloat16),
                                     (290, torch.bfloat16), (7, torch.float32),
                                     (70, torch.float32)])
def test_w4_kernels(cuda, m, dtype):
    """K11 (GEMV: fp32, or at most 16 rows) and K11mma (more bf16 rows)
    against ``w4_matmul_plain``: fp32 within 1e-4 (sums in another order),
    bf16 within 2e-2 at |y| ~ 1 (one bf16 step plus order)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    k, n = 1024, 768
    w = quantize_int4(torch.randn(k, n, generator=g, device=cuda).mul_(0.05))
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    counts = (pw4.K11.launches, pw4.K11MMA.launches)
    got = pw4.w4_matmul(x, w["q4"], w["s4"])
    mma = dtype == torch.bfloat16 and m > pw4.GEMV_MAX_ROWS
    assert (pw4.K11.launches - counts[0], pw4.K11MMA.launches - counts[1]) == (int(not mma),
                                                                              int(mma))
    want = pw4.w4_matmul_plain(x, w["q4"], w["s4"])
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_nosm_kernel(cuda):
    """P1 within one bf16 step at its largest output of its plain version
    (probabilities of ~1e-4 make outputs ~1e-3); 77 keys pad a partial
    tile."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 77, 4, 112, generator=g, device=cuda).bfloat16() for _ in range(3))
    got = pdense.dense_attention_nosm(q, k, v, 112 ** -0.5)
    want = pdense.dense_attention_nosm_plain(q, k, v, 112 ** -0.5)
    top = want.abs().max().item()
    assert top > 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -7 * top, rtol=0)
