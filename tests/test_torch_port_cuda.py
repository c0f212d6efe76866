"""The port's CUDA kernels (K1-K11, P1) against their plain PyTorch versions
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


def _flash_bwd_case(cuda, b, s, h, d, dtype, causal, masked):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
                     for _ in range(4))
    seg = torch.ones(b, s, dtype=torch.int32, device=cuda)
    kv_seg = seg
    if masked:  # packed segments, a padded tail, a query whose segment has no key
        seg = seg.clone()
        seg[0, s // 2:] = 2
        seg[-1, s - s // 5:] = 0
        kv_seg = seg.clone()
        kv_seg[0, s // 2:s // 2 + 3] = 3
    scale = d ** -0.5
    out, lse = pflash.flash_segment_attention(q, k, v, seg, kv_seg, causal=causal, scale=scale)
    # K3's forward at the same shape feeds K7: held first, so a K3 fault
    # cannot cancel out of the comparison below
    rout, rlse = pflash.flash_segment_attention_plain(q, k, v, seg, kv_seg, causal=causal,
                                                      scale=scale)
    frac = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (out.float() - rout.float()).abs().max().item()
    assert err <= frac * rout.float().abs().max().item(), f"K3 out: max_abs_err {err}"
    assert (lse - rlse).abs().max().item() <= 1e-3
    got = pflash.flash_segment_attention_bwd(q, k, v, seg, kv_seg, out, lse, dout,
                                             causal=causal, scale=scale)
    ref = pflash.flash_segment_attention_bwd_plain(q, k, v, seg, kv_seg, out, lse, dout,
                                                   causal=causal, scale=scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == r.shape
        tol = frac * r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol, f"{name}: max_abs_err {err} > {tol}"
    if masked and causal:
        assert torch.all(got[0][0, s // 2] == 0) and torch.all(got[0][-1, s - s // 5:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype,causal,masked", [
    (4, 1024, 32, 128, torch.bfloat16, True, False),  # the LLM site
    (4, 577, 16, 112, torch.bfloat16, False, False),  # the flagship ViT, bf16 image
    (4, 577, 16, 112, torch.float32, False, False),  # the flagship ViT, fp32 image
    (4, 512, 12, 64, torch.float32, False, False),  # the SAM encoder
    (2, 150, 2, 88, torch.bfloat16, True, True),
    (2, 150, 2, 88, torch.bfloat16, False, True),
    (2, 99, 3, 16, torch.float32, True, True),
    (2, 70, 2, 120, torch.float32, False, True),
])
def test_flash_bwd_kernels(cuda, b, s, h, d, dtype, causal, masked):
    """K3's forward, then K7dq and K7dkv, against the plain versions: within
    2e-2 (bf16) or 1e-4 (fp32) of each output's largest magnitude, lse
    within 1e-3."""
    _flash_bwd_case(cuda, b, s, h, d, dtype, causal, masked)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [17, 64, 65, 92, 184, 290, 292, 580, 584])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 4096), (4096, 11008)])
def test_w4_mma_kernel_shapes(cuda, m, k, n):
    """K11mma (wgmma over a TMA ring) at the row counts W4A16 serving passes
    (vision and text rows, whole and in chunks of 2, and tile edges) on the
    flagship's weight shapes, through the tile width ``mma_tpw`` picks and
    through the other one: within one bf16 step (2**-7) of the largest
    output of ``w4_matmul_plain``, the same weight rounding."""
    g = torch.Generator(device=cuda).manual_seed(m)
    w = quantize_int4(torch.randn(k, n, generator=g, device=cuda).mul_(0.02))
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    assert pw4.route(m, k, n, 128, x.dtype) == "K11mma"
    before = pw4.K11MMA.launches
    got = pw4.w4_matmul(x, w["q4"], w["s4"])
    assert pw4.K11MMA.launches == before + 1
    want = pw4.w4_matmul_plain(x, w["q4"], w["s4"])
    top = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -7 * top)
    other = torch.empty_like(got)
    pw4.K11MMA(x.data_ptr(), w["q4"].data_ptr(), w["s4"].data_ptr(), other.data_ptr(), m, k, n,
               128, 3 - pw4.mma_tpw(m, n), pw4._cuda.stream_of(x))
    torch.testing.assert_close(other.float(), want.float(), rtol=0, atol=2 ** -7 * top)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 88, 112, 128])
@pytest.mark.parametrize("s", [150, 577])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_head_dims(cuda, d, s, dtype):
    """K7 at every head dim it serves, over a ragged S (partial tiles at
    both kernels' edges), masked and causal."""
    _flash_bwd_case(cuda, 1, s, 2, d, dtype, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_repeats_bit_for_bit(cuda, dtype):
    """No atomics: two runs of K7dq and K7dkv at the LLM site's widths give
    equal bits."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, dout = (torch.randn(2, 1024, 8, 128, generator=g, device=cuda).to(dtype)
                     for _ in range(4))
    seg = torch.ones(2, 1024, dtype=torch.int32, device=cuda)
    out, lse = pflash.flash_segment_attention(q, k, v, seg, seg, causal=True, scale=0.088)
    runs = [pflash.flash_segment_attention_bwd(q, k, v, seg, seg, out, lse, dout, causal=True,
                                               scale=0.088) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (112, torch.float32),
                                     (8, torch.float32)])
def test_flash_bwd_delta_kernel(cuda, d, dtype):
    """K7delta against ``_delta`` within 1e-5 of the largest |delta|."""
    g = torch.Generator(device=cuda).manual_seed(3)
    out, dout = (torch.randn(2, 77, 3, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    seg = torch.ones(2, 77, dtype=torch.int32, device=cuda)
    lse = torch.zeros(2, 3, 77, device=cuda)
    before = pflash.K7DELTA.launches
    pflash.flash_segment_attention_bwd(out, out, out, seg, seg, out, lse, dout, causal=False,
                                       scale=1.0)
    assert pflash.K7DELTA.launches == before + 1
    got = torch.empty(2, 3, 77, device=cuda)
    pflash.K7DELTA(out.data_ptr(), dout.data_ptr(), got.data_ptr(), 2, 77, 3, d,
                   int(dtype == torch.bfloat16), pflash._cuda.stream_of(out))
    want = pflash._delta(out, dout)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_kernels_refuse_shapes_they_cannot_take(cuda):
    """A CUDA tensor of a shape the kernel cannot take raises; it never
    falls back to the plain version."""
    q = torch.zeros(1, 16, 2, 20, device=cuda).bfloat16()
    seg = torch.ones(1, 16, dtype=torch.int32, device=cuda)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        pflash.flash_segment_attention_bwd(q, q, q, seg, seg, q, lse, q, causal=False, scale=1.0)
    w = quantize_int4(torch.randn(256, 256, device=cuda))
    x = torch.zeros(32, 256, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        pw4.w4_matmul(x, w["q4"][:, :192].contiguous(), w["s4"][:, :192].contiguous())


@pytest.mark.cuda
def test_flash_attention_refuses_a_head_dim_k7_cannot_take_before_the_forward(cuda):
    """A differentiable site whose head dim K7 cannot take (bf16 D = 100)
    raises in the forward, before K3 runs, not in the backward."""
    q = torch.zeros(1, 16, 2, 100, device=cuda).bfloat16().requires_grad_()
    seg = torch.ones(1, 16, dtype=torch.int32, device=cuda)
    before = pflash.K3.launches
    with pytest.raises(ValueError, match="K7 does not take"):
        pflash.flash_attention(q, q, q, seg, seg, causal=False, scale=0.1)
    assert pflash.K3.launches == before
