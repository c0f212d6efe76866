"""The port's CUDA kernels (K1-K12, P1, LAP) against their plain PyTorch versions
on the card. Every test is marked ``cuda`` and skips without a GPU.

This file imports neither JAX nor ``mmmm_tpu``, so it also runs where only
PyTorch is installed; tests/conftest.py imports JAX, so on such a machine
run it as ``python3 -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""
import pytest
import torch

from mmmm_tpu_torch.ops import attention as pattn
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
@pytest.mark.parametrize("nq", [1, 3, 8])
@pytest.mark.parametrize("d", [128, 64])
def test_window_kernel_flagship(cuda, nq, d):
    """K6's tensor-core form at run (b)'s cache (4, 32, 328, D) in bf16, 11
    warps of a 32-slot tile: write indices from 0, mid-cache, at Smax - NQ
    and Smax - 1, negative, at tile edges and with warps that hold no valid
    slot, within 2e-2 of the plain version; one launch a call; two runs
    equal bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(nq + d)
    b, h, smax = 4, 32, 328
    assert pdec.window_mma_takes(torch.bfloat16, d) and pdec.window_warps(smax) == (11, 1)
    kc, vc = (torch.randn(b, h, smax, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    q = torch.randn(b, nq, h, d, generator=g, device=cuda).bfloat16()
    for widx in ([256] * 4, [0, 150, smax - nq, smax - 1], [-1, -nq - 3, 127, 128 - nq],
                 [128, 256 - nq, 251, 5]):
        w = torch.tensor(widx, dtype=torch.int32, device=cuda)
        before = pdec.K6.launches
        got = pdec.decode_attention_window(q, kc, vc, w)
        assert pdec.K6.launches == before + 1
        torch.testing.assert_close(got.float(),
                                   pdec.decode_attention_window_plain(q, kc, vc, w).float(),
                                   rtol=0, atol=2e-2)
        assert torch.equal(got, pdec.decode_attention_window(q, kc, vc, w))
    w = torch.tensor([-1, -nq - 3, 0, 0], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention_window(q, kc, vc, w)
    assert torch.all(got[:2, 0] == 0)  # query 0 of those samples sees no slot


@pytest.mark.cuda
def test_window_kernel_several_steps_a_block(cuda):
    """K6 over Smax 2100: 6 warps of 11 tiles of 32 slots (the cp.async
    double buffer of each warp), within 2e-2 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(21)
    assert pdec.window_warps(2100) == (6, 11)
    kc, vc = (torch.randn(2, 2, 2100, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    q = torch.randn(2, 8, 2, 128, generator=g, device=cuda).bfloat16()
    w = torch.tensor([2092, 700], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(pdec.decode_attention_window(q, kc, vc, w).float(),
                               pdec.decode_attention_window_plain(q, kc, vc, w).float(),
                               rtol=0, atol=2e-2)


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
                                     (64, torch.float32), (48, torch.bfloat16),
                                     (80, torch.float32), (100, torch.bfloat16),
                                     (90, torch.float32), (8, torch.bfloat16)])
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
def test_q8_mxu_kernel_past_shared_memory(cuda):
    """K10 over more slots than its logits' shared memory holds (they go to
    a workspace), where the reference's gate admits it (H % 4 != 0, D =
    16): within 1e-4 of its plain version."""
    b, h, d = 1, 3, 16
    smax = pdec.Q8_MXU_SHARED_SLOTS + 7232
    assert pdec._q8_mxu_eligible(h, smax, d) and not pdec.q8_mxu_in_shared(smax)
    g = torch.Generator(device=cuda).manual_seed(7)
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda)
    kv_len = torch.tensor([smax - 3], dtype=torch.int32, device=cuda)
    before = pdec.K10.launches
    got = pdec.decode_attention_q8(q, kq, ks, vq, vs, kv_len, q8_mxu=True)
    assert pdec.K10.launches == before + 1
    torch.testing.assert_close(got, pdec.decode_attention_q8_mxu_plain(q, kq, ks, vq, vs, kv_len),
                               rtol=0, atol=1e-4)


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


def _q8_reads(mxu):
    if mxu:
        return pdec.decode_attention_q8_mxu, pdec.decode_attention_q8_mxu_plain
    return pdec.decode_attention_q8, pdec.decode_attention_q8_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("smax", [320, 321])
@pytest.mark.parametrize("mxu", [False, True])
def test_q8_reads_at_the_flagship_shape(cuda, mxu, smax, dtype):
    """K9 and K10 at the flagship's decode shape (H = 32, D = 128) for
    kv_len 1, 193, 256, 320 and 0, over Smax 320 (every slab of the staged
    read one bulk copy) and 321 (a head's scales start off a 16-byte
    boundary: head and tail bytes): within 2e-2 (bf16 q) / 1e-4 (fp32 q) of
    the plain versions, zeros at kv_len 0, and twice bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(smax)
    b, h, d = 5, 32, 128
    chunk, stages = pdec.q8_stage_plan(smax, d, mxu=mxu)
    assert stages == 2 and chunk >= smax  # the whole read
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([1, 193, 256, 320, 0], dtype=torch.int32, device=cuda)
    fn, plain = _q8_reads(mxu)
    got = fn(q, kq, ks, vq, vs, kv_len)
    torch.testing.assert_close(got.float(), plain(q, kq, ks, vq, vs, kv_len).float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.all(got[4] == 0)
    assert torch.equal(got, fn(q, kq, ks, vq, vs, kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mxu,smax,d", [(False, 4096, 128), (False, 4096, 90),
                                        (True, 1536, 128), (True, 1536, 90)])
def test_q8_reads_through_the_ring(cuda, mxu, smax, d, dtype):
    """K9 over Smax 4096 and K10 over 1536 (the reference's longest
    split-int8 cache at H = 32, D = 128), where a head's rows stream through
    the staged read's ring of 4 stages, at D = 128 and at D = 90 (rows and
    scales off 16-byte boundaries): kv_len 0, inside the first chunk, just
    past a chunk's end and Smax; within 2e-2 (bf16 q) / 1e-4 (fp32 q) of
    the plain versions, and twice bit for bit."""
    chunk, stages = pdec.q8_stage_plan(smax, d, mxu=mxu)
    assert stages == 4 and chunk < smax
    g = torch.Generator(device=cuda).manual_seed(smax + d)
    b, h = 4, 8
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([0, chunk - 5, 2 * chunk + 1, smax], dtype=torch.int32, device=cuda)
    fn, plain = _q8_reads(mxu)
    got = fn(q, kq, ks, vq, vs, kv_len)
    torch.testing.assert_close(got.float(), plain(q, kq, ks, vq, vs, kv_len).float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.all(got[0] == 0)
    assert torch.equal(got, fn(q, kq, ks, vq, vs, kv_len))


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
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096)])
def test_w4_gemv_decode_shapes(cuda, m, k, n):
    """K11 at decode rows on run (d)'s four weight shapes (bf16: the
    tensor-core form over a cluster that splits K): one launch a call,
    within one bf16 step (2**-7) of the largest output of
    ``w4_matmul_plain``, two runs equal bit for bit; fp32 x at M = 4 within
    1e-5 of the largest output."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    w = quantize_int4(torch.randn(k, n, generator=g, device=cuda).mul_(0.02))
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    assert pw4.route(m, k, n, 128, x.dtype) == "K11"
    before = pw4.K11.launches
    got = pw4.w4_matmul(x, w["q4"], w["s4"])
    assert pw4.K11.launches == before + 1
    want = pw4.w4_matmul_plain(x, w["q4"], w["s4"])
    top = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -7 * top)
    assert torch.equal(got, pw4.w4_matmul(x, w["q4"], w["s4"]))
    if m == 4:
        xf = x.float()
        want = pw4.w4_matmul_plain(xf, w["q4"], w["s4"])
        torch.testing.assert_close(pw4.w4_matmul(xf, w["q4"], w["s4"]), want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


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
    q = torch.zeros(1, 16, 2, 136, device=cuda).bfloat16()
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
    """A differentiable site whose head dim K7 cannot take (bf16 D = 136)
    raises in the forward, before K3 runs, not in the backward."""
    q = torch.zeros(1, 16, 2, 136, device=cuda).bfloat16().requires_grad_()
    seg = torch.ones(1, 16, dtype=torch.int32, device=cuda)
    before = pflash.K3.launches
    with pytest.raises(ValueError, match="K7 does not take"):
        pflash.flash_attention(q, q, q, seg, seg, causal=False, scale=0.1)
    assert pflash.K3.launches == before


# ---- the forward attention kernels (K3, K4; K12 and P1 run K4's) -------------------

def _fwd_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,s,h,d,dtype,causal", [
    ("K4", 2, 1153, 16, 112, torch.bfloat16, False),  # the ViT (bf16) at its S
    ("K4", 2, 75, 12, 64, torch.float32, False),  # the SAM encoder's widths
    ("K3", 2, 577, 32, 128, torch.bfloat16, True),  # the LLM's widths, causal
    ("K3", 2, 577, 16, 112, torch.bfloat16, False),  # the training ViT, bf16 image
    ("K3", 2, 577, 16, 112, torch.float32, False),  # the training ViT, fp32 image
    ("K3", 2, 75, 12, 64, torch.float32, False),  # the SAM encoder in training
    ("K4", 2, 33, 2, 8, torch.bfloat16, False),  # tiny head dims
    ("K3", 2, 40, 2, 16, torch.bfloat16, True),
    ("K3", 2, 40, 2, 8, torch.float32, True),
])
def test_forward_attention_sites(cuda, kernel, b, s, h, d, dtype, causal):
    """K3 (out and lse) and K4 against their plain versions at each site's
    widths over a ragged S: within 2e-2 (bf16) or 1e-4 (fp32) of the
    largest output, lse within 1e-3; each call one launch."""
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    scale = d ** -0.5
    if kernel == "K4":
        before = pdense.K4.launches
        got = pdense.dense_attention(q, k, v, scale)
        assert pdense.K4.launches == before + 1
        ref = pdense.dense_attention_plain(q, k, v, scale)
    else:
        seg = torch.ones(b, s, dtype=torch.int32, device=cuda)
        before = pflash.K3.launches
        got, lse = pflash.flash_segment_attention(q, k, v, seg, seg, causal=causal, scale=scale)
        assert pflash.K3.launches == before + 1
        ref, rlse = pflash.flash_segment_attention_plain(q, k, v, seg, seg, causal=causal,
                                                         scale=scale)
        assert (lse - rlse).abs().max().item() <= 1e-3
    assert got.dtype == dtype and got.shape == q.shape
    top = max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_fwd_tol(dtype) * top)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (112, torch.bfloat16),
                                     (112, torch.float32), (64, torch.float32)])
def test_flash_forward_masked_rows_and_segments(cuda, d, dtype):
    """K3, causal over two packed segments, a padded tail and query rows
    whose segment has no key: those rows give out and lse exactly 0, the
    rest match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(d)
    b, s, h = 2, 300, 3
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    seg = torch.ones(b, s, dtype=torch.int32, device=cuda)
    seg[0, 130:] = 2  # the second segment starts inside a tile
    seg[1, 250:] = 0  # padded tail
    kv_seg = seg.clone()
    kv_seg[0, 130:140] = 3  # queries 130..139 of sample 0 see no key when causal
    out, lse = pflash.flash_segment_attention(q, k, v, seg, kv_seg, causal=True, scale=0.1)
    ref, rlse = pflash.flash_segment_attention_plain(q, k, v, seg, kv_seg, causal=True,
                                                     scale=0.1)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=_fwd_tol(dtype))
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-3)
    assert torch.all(out[0, 130:140] == 0) and torch.all(lse[0, :, 130:140] == 0)
    assert torch.all(out[1, 250:] == 0) and torch.all(lse[1, :, 250:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_attention_repeats_bit_for_bit(cuda, dtype):
    """No atomics: two runs of K3 (causal, the LLM's widths) and of K4 (the
    ViT's) give equal bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(2, 1024, 8, 128, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    seg = torch.ones(2, 1024, dtype=torch.int32, device=cuda)
    runs = [pflash.flash_segment_attention(q, k, v, seg, seg, causal=True, scale=0.088)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    q, k, v = (t[:, :577, :, :112].contiguous() for t in (q, k, v))
    assert torch.equal(pdense.dense_attention(q, k, v, 0.09), pdense.dense_attention(q, k, v, 0.09))


@pytest.mark.cuda
def test_nosm_kernel_at_the_vit_shape(cuda):
    """P1 at the flagship ViT's shape, within one bf16 step at its largest
    output of its plain version."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(4, 1153, 16, 112, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    got = pdense.dense_attention_nosm(q, k, v, 112 ** -0.5)
    want = pdense.dense_attention_nosm_plain(q, k, v, 112 ** -0.5)
    top = want.abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -7 * top, rtol=0)


# ---- head dims the kernels take only through zero lanes, or by a scalar tail ------

@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(100, torch.bfloat16), (90, torch.float32)])
def test_padded_head_dims_forward_and_backward(cuda, d, dtype):
    """K4, K3 and K7 at a head dim they take through the zero-lane pad
    (``kernel_head_dim``): one launch a call, equal to the plain versions
    at D (K3's and K7's checks of ``_flash_bwd_case``, masked and causal)."""
    assert pattn.kernel_head_dim(d, dtype) not in (None, d)
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(2, 150, 3, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = pdense.K4.launches
    got = pdense.dense_attention(q, k, v, d ** -0.5)
    assert pdense.K4.launches == before + 1 and got.shape == q.shape
    torch.testing.assert_close(got.float(), pdense.dense_attention_plain(q, k, v, d ** -0.5).float(),
                               rtol=0, atol=_fwd_tol(dtype))
    before = (pflash.K3.launches, pflash.K7DQ.launches, pflash.K7DKV.launches)
    _flash_bwd_case(cuda, 2, 150, 3, d, dtype, True, True)
    assert (pflash.K3.launches, pflash.K7DQ.launches, pflash.K7DKV.launches) == tuple(
        n + 1 for n in before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_reads_at_head_dim_90(cuda, dtype):
    """K1, K6 and K9 at D = 90 (rows not a whole number of their vector
    loads: the scalar tail), against their plain versions: kv_len 0 and
    Smax, windows at either end."""
    g = torch.Generator(device=cuda).manual_seed(90)
    b, h, smax, d = 3, 4, 50, 90
    kc, vc = (torch.randn(b, h, smax, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    tol = dict(rtol=0, atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([0, 23, smax], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention(q, kc, vc, kv_len)
    torch.testing.assert_close(got.float(), pdec.decode_attention_plain(q, kc, vc, kv_len).float(),
                               **tol)
    assert torch.all(got[0] == 0)
    qw = torch.randn(b, 5, h, d, generator=g, device=cuda).to(dtype)
    w = torch.tensor([0, 20, smax - 5], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(pdec.decode_attention_window(qw, kc, vc, w).float(),
                               pdec.decode_attention_window_plain(qw, kc, vc, w).float(), **tol)
    kq, ks = quantize_kv(kc.float())
    vq, vs = quantize_kv(vc.float())
    got = pdec.decode_attention_q8(q, kq, ks, vq, vs, kv_len)
    torch.testing.assert_close(got.float(),
                               pdec.decode_attention_q8_plain(q, kq, ks, vq, vs, kv_len).float(),
                               **tol)
    assert torch.all(got[0] == 0)


def _k1_inputs(g, cuda, b, h, smax, d, dtype):
    return (torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype),
            *(torch.randn(b, h, smax, d, generator=g, device=cuda).to(dtype) for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 64, 90])
@pytest.mark.parametrize("smax", [320, 321])
def test_decode_read_at_the_flagship_shape(cuda, smax, d, dtype):
    """K1 at H = 32 over Smax 320 and 321 (a warp's run starting off a
    16-byte boundary where D = 90) for kv_len 1, 193, 256, 320 and 0 at
    B = 4 (a block a head; in fp32 each warp's rows through its ring) and
    B = 1 (a head's slots over a cluster of 5 blocks): within 2e-2 (bf16) /
    1e-4 (fp32) of the plain version, zeros at kv_len 0, twice bit for bit."""
    sms = pdec.sm_count(cuda)
    assert pdec.decode_splits(4, 32, smax, sms) == 1 and pdec.decode_splits(1, 32, smax, sms) == 5
    g = torch.Generator(device=cuda).manual_seed(smax + d)
    tol = dict(rtol=0, atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    q, kc, vc = _k1_inputs(g, cuda, 4, 32, smax, d, dtype)
    for lens in ([1, 193, 256, 320], [0, 256, 0, 193]):
        n = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = pdec.decode_attention(q, kc, vc, n)
        torch.testing.assert_close(got.float(), pdec.decode_attention_plain(q, kc, vc, n).float(),
                                   **tol)
        assert torch.all(got[n == 0] == 0)
        assert torch.equal(got, pdec.decode_attention(q, kc, vc, n))
    for n1 in (1, 193, 256, 320, 0):
        n = torch.tensor([n1], dtype=torch.int32, device=cuda)
        got = pdec.decode_attention(q[:1], kc[:1], vc[:1], n)
        torch.testing.assert_close(
            got.float(), pdec.decode_attention_plain(q[:1], kc[:1], vc[:1], n).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 90])
def test_decode_read_past_shared_memory(cuda, d, dtype):
    """K1 over Smax 8192 (8 splits), where each warp's 128 slots stream
    through its staged read's ring of 4 stages: within tolerance, twice bit
    for bit."""
    smax, b, h = 8192, 2, 8
    splits = pdec.decode_splits(b, h, smax, pdec.sm_count(cuda))
    elem = 2 if dtype == torch.bfloat16 else 4
    chunk, stages = pdec.decode_stage_plan(smax, splits, d, elem)
    assert splits == 8 and stages == 4 and chunk < smax // splits // pdec.DECODE_WARPS
    g = torch.Generator(device=cuda).manual_seed(d)
    q, kc, vc = _k1_inputs(g, cuda, b, h, smax, d, dtype)
    n = torch.tensor([smax, 3 * chunk + 5], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention(q, kc, vc, n)
    torch.testing.assert_close(got.float(), pdec.decode_attention_plain(q, kc, vc, n).float(),
                               rtol=0, atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(got, pdec.decode_attention(q, kc, vc, n))


@pytest.mark.cuda
@pytest.mark.parametrize("b,smax,d", [(4, 432, 128), (4, 1024, 96), (2, 1296, 128),
                                      (1, 2160, 128)])
def test_decode_read_near_the_shared_memory_limit(cuda, b, smax, d):
    """K1 in bf16 at H = 32 over caches whose plan fills the block's shared
    memory to within a few KiB of the card's limit (dynamic plus static):
    the read and the fused form within 2e-2 of their plain versions, the
    caches bit-equal to ``kv_append_plain``'s."""
    h, dt = 32, torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(smax + d)
    q, kc, vc = _k1_inputs(g, cuda, b, h, smax, d, dt)
    kn, vn = (torch.randn(b, h, 1, d, generator=g, device=cuda).to(dt) for _ in range(2))
    n = torch.tensor([smax, smax - 129, 1, smax // 2][:b], dtype=torch.int32, device=cuda)
    w = torch.tensor([smax - 1, 7, -1, smax][:b], dtype=torch.int32, device=cuda)
    tol = dict(rtol=0, atol=2e-2)
    torch.testing.assert_close(pdec.decode_attention(q, kc, vc, n).float(),
                               pdec.decode_attention_plain(q, kc, vc, n).float(), **tol)
    rk, rv = kc.clone(), vc.clone()
    ref = pdec.decode_attention_append_plain(q, rk, rv, kn, vn, w, n)
    got = pdec.decode_attention_append(q, kc, vc, kn, vn, w, n)
    assert torch.equal(kc, rk) and torch.equal(vc, rv)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_read_split_kv_len_sweep(cuda, dtype):
    """K1 at B = 1, H = 32 over Smax 320 (5 splits a head on the H100) for
    every kv_len from 0 to 320: each split's run, empty or not, and its
    warps' shares cover the valid slots once (within tolerance of the plain
    version, which reads each once)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, kc, vc = _k1_inputs(g, cuda, 1, 32, 320, 128, dtype)
    tol = dict(rtol=0, atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    for n1 in range(0, 321):
        n = torch.tensor([n1], dtype=torch.int32, device=cuda)
        torch.testing.assert_close(pdec.decode_attention(q, kc, vc, n).float(),
                                   pdec.decode_attention_plain(q, kc, vc, n).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 64, 90])
@pytest.mark.parametrize("widx,lens", [([192, 0, 319, 327], [193, 1, 320, 320]),
                                       ([-1, 5, 300, -400], [320, 6, 301, 256]),
                                       ([256, 200, 10, 319], [193, 0, 5, 256])])
def test_decode_append_fused(cuda, widx, lens, d, dtype):
    """K1's fused form over Smax 320 at write indices in range, at the last
    slot, past Smax, negative, and at or past kv_len (t >= kv_len): the
    caches bit-equal to ``kv_append_plain``'s, the output within 2e-2 (bf16)
    / 1e-4 (fp32) of the plain fused version, twice bit for bit; one K1
    launch of form "append", no K2 launch."""
    g = torch.Generator(device=cuda).manual_seed(d + widx[0])
    q, kc, vc = _k1_inputs(g, cuda, 4, 32, 320, d, dtype)
    kn, vn = (torch.randn(4, 32, 1, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    w = torch.tensor(widx, dtype=torch.int32, device=cuda)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    rk, rv = kc.clone(), vc.clone()
    ref = pdec.decode_attention_append_plain(q, rk, rv, kn, vn, w, n)
    outs = []
    for _ in range(2):
        gk, gv = kc.clone(), vc.clone()
        before = (pdec.K1.launches, pdec.K1.forms.get("append", 0), pdec.K2.launches)
        outs.append(pdec.decode_attention_append(q, gk, gv, kn, vn, w, n))
        assert (pdec.K1.launches, pdec.K1.forms.get("append", 0), pdec.K2.launches) == (
            before[0] + 1, before[1] + 1, before[2])
        assert torch.equal(gk, rk) and torch.equal(gv, rv)
    torch.testing.assert_close(outs[0].float(), ref.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(outs[0], outs[1])


# ---- the fused forms: K8's append (and quantize_kv) inside K9/K10, K5's inside K6 --------

def _q8_step(g, cuda, b, h, smax, d, dtype, rows=None):
    """An int8 cache and a decode step's q and new K/V rows (B, 1, H, D) in
    ``dtype``, as views of one fused projection unless ``rows`` says
    contiguous, or unaligned (rows 2 elements into rows of D + 4)."""
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    qkv = torch.randn(b, 1, 3 * h, d, generator=g, device=cuda).to(dtype)
    q, kn, vn = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    if rows == "contiguous":
        q, kn, vn = q.contiguous(), kn.contiguous(), vn.contiguous()
    if rows == "unaligned":
        wide = torch.zeros(2, b, 1, h, d + 4, device=cuda, dtype=dtype)
        wide[..., 2:d + 2] = torch.stack([kn, vn])
        kn, vn = wide[0, ..., 2:d + 2], wide[1, ..., 2:d + 2]
    return q.contiguous(), {"kq": kq, "ks": ks, "vq": vq, "vs": vs}, kn, vn


def _check_q8_append(cache, q, kn, vn, widx, lens, mxu, cast="f32", atol=None):
    """The fused int8 step against the kernels in sequence (``quantize_kv``,
    K8, then K9 or K10) and against the plain sequence: caches bit-equal to
    both, the output bit-equal to the kernels' and twice bit for bit; one
    launch of the read in its form "append" (and K9's "bf16" with
    ``cast="bf16"``), no K8 launch."""
    cuda = q.device
    w = torch.tensor(widx, dtype=torch.int32, device=cuda)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    plain = {k: t.clone() for k, t in cache.items()}
    ref = pdec.decode_attention_q8_append_plain(q, plain, kn, vn, w, n, q8_mxu=mxu, cast=cast)
    seq = {k: t.clone() for k, t in cache.items()}
    pdec.kv_append_q8(seq, *quantize_kv(kn.transpose(1, 2)), *quantize_kv(vn.transpose(1, 2)), w)
    want = pdec.decode_attention_q8(q, *(seq[k] for k in pdec.Q8_LEAVES), n, q8_mxu=mxu,
                                    cast=cast)
    kern = pdec.K10 if pdec._takes_mxu(mxu, cast, cache["kq"].shape[1:]) else pdec.K9
    outs = []
    for _ in range(2):
        got_cache = {k: t.clone() for k, t in cache.items()}
        before = (kern.launches, kern.forms.get("append", 0), kern.forms.get("bf16", 0),
                  pdec.K8.launches)
        outs.append(pdec.decode_attention_q8_append(q, got_cache, kn, vn, w, n, q8_mxu=mxu,
                                                    cast=cast))
        assert (kern.launches, kern.forms.get("append", 0), kern.forms.get("bf16", 0),
                pdec.K8.launches) == (before[0] + 1, before[1] + 1,
                                      before[2] + (cast == "bf16"), before[3])
        for k in pdec.Q8_LEAVES:
            assert torch.equal(got_cache[k], plain[k]), k
            assert torch.equal(got_cache[k], seq[k]), k
    assert torch.equal(outs[0], want) and torch.equal(outs[0], outs[1])
    if atol is None:
        atol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(outs[0].float(), ref.float(), rtol=0, atol=atol)
    assert torch.all(outs[0][n <= 0] == 0)


# the flagship's decode (H = 32, Smax 320 and 321): t = kv_len - 1, the first
# and the last slot, past Smax, negative (from the end), t >= kv_len (written,
# not read), kv_len 0
Q8_EDGES = [([192, 0, 319, 327], [193, 1, 320, 320]), ([-1, 5, 300, -400], [320, 6, 301, 256]),
            ([256, 200, 10, 319], [193, 0, 5, 256])]


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 90])
@pytest.mark.parametrize("smax", [320, 321])
def test_q8_append_fused_at_the_flagship(cuda, smax, d, dtype, mxu):
    """K9's and K10's fused forms at B = 4 and B = 1, H = 32, at every
    write-index edge: the in-launch quantization gives ``quantize_kv``'s
    bits (caches bit-equal), the output is K8 then the read's, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(smax + d + mxu)
    q, cache, kn, vn = _q8_step(g, cuda, 4, 32, smax, d, dtype)
    for widx, lens in Q8_EDGES:
        _check_q8_append(cache, q, kn, vn, widx, lens, mxu)
    for widx, lens in (([255], [256]), ([smax - 1], [0]), ([-3], [smax])):
        _check_q8_append({k: t[:1] for k, t in cache.items()}, q[:1], kn[:1], vn[:1], widx,
                         lens, mxu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mxu,smax,d", [(False, 4096, 128), (False, 4096, 90),
                                        (True, 1536, 128), (True, 1536, 90)])
def test_q8_append_fused_through_the_ring(cuda, mxu, smax, d, dtype):
    """The fused forms where a head's rows stream through the staged read's
    ring: the new row in the first chunk, in a later one, past kv_len, at
    Smax - 1 and negative."""
    chunk, stages = pdec.q8_stage_plan(smax, d, mxu=mxu)
    assert stages == 4 and chunk < smax
    g = torch.Generator(device=cuda).manual_seed(smax + d)
    q, cache, kn, vn = _q8_step(g, cuda, 4, 8, smax, d, dtype, rows="contiguous")
    _check_q8_append(cache, q, kn, vn, [chunk - 6, 2 * chunk, smax - 1, -1],
                     [chunk - 5, 2 * chunk + 1, smax - 100, smax], mxu)
    _check_q8_append(cache, q, kn, vn, [0, chunk + 3, 5, smax + 2],
                     [0, chunk + 1, 2 * chunk + 1, smax], mxu)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 90])
def test_q8_append_fused_takes_unaligned_rows(cuda, d, dtype, mxu):
    """New rows that do not start on 16 bytes: copied into an aligned tensor
    where D % 16 == 0 (the kernel reads them by 16-byte pieces), read in
    place at D = 90; the same bits either way."""
    g = torch.Generator(device=cuda).manual_seed(d + mxu)
    q, cache, kn, vn = _q8_step(g, cuda, 4, 32, 320, d, dtype, rows="unaligned")
    assert kn.data_ptr() % 16 and kn.stride(2) == d + 4
    for widx, lens in Q8_EDGES:
        _check_q8_append(cache, q, kn, vn, widx, lens, mxu)


@pytest.mark.cuda
def test_q8_mxu_append_fused_past_shared_memory(cuda):
    """K10's fused form over more slots than its shared memory holds (the
    logits in a workspace), where the reference's gate admits it."""
    b, h, d = 1, 3, 16
    smax = pdec.Q8_MXU_SHARED_SLOTS + 7232
    assert pdec._q8_mxu_eligible(h, smax, d) and not pdec.q8_mxu_in_shared(smax)
    g = torch.Generator(device=cuda).manual_seed(8)
    q, cache, kn, vn = _q8_step(g, cuda, b, h, smax, d, torch.float32)
    _check_q8_append(cache, q, kn, vn, [smax - 4], [smax - 3], True)
    _check_q8_append(cache, q, kn, vn, [-1], [smax], True)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("d", [128, 16])
def test_q8_append_fused_near_the_shared_memory_limit(cuda, mxu, d):
    """The fused forms over the longest cache whose whole read still fits
    (the most dynamic shared memory a whole-read plan takes): their static
    arrays leave it room to launch."""
    smax = max(s for s in range(16, 8192, 16) if pdec.q8_stage_plan(s, d, mxu=mxu)[1] == 2)
    assert pdec.q8_stage_plan(smax + 16, d, mxu=mxu)[1] == pdec.Q8_RING_STAGES
    if mxu:
        assert pdec._q8_mxu_eligible(1, smax, d)
    g = torch.Generator(device=cuda).manual_seed(smax)
    q, cache, kn, vn = _q8_step(g, cuda, 2, 1, smax, d, torch.bfloat16)
    _check_q8_append(cache, q, kn, vn, [smax - 1, 17], [smax, 18], mxu)


def _check_window_append(kc, vc, q, kn, vn, widx):
    """The fused verify step against K5 then K6 and against the plain
    sequence: caches bit-equal to both, the output bit-equal to the kernels'
    and twice bit for bit; one K6 launch in its form "append", no K5
    launch."""
    w = torch.tensor(widx, dtype=torch.int32, device=q.device)
    pk, pv = kc.clone(), vc.clone()
    ref = pdec.decode_attention_window_append_plain(q, pk, pv, kn, vn, w)
    sk, sv = kc.clone(), vc.clone()
    pdec.kv_append_multi(sk, sv, kn.transpose(1, 2).contiguous(), vn.transpose(1, 2).contiguous(),
                         w)
    want = pdec.decode_attention_window(q, sk, sv, w)
    outs = []
    for _ in range(2):
        gk, gv = kc.clone(), vc.clone()
        before = (pdec.K6.launches, pdec.K6.forms.get("append", 0), pdec.K5.launches)
        outs.append(pdec.decode_attention_window_append(q, gk, gv, kn, vn, w))
        assert (pdec.K6.launches, pdec.K6.forms.get("append", 0), pdec.K5.launches) == (
            before[0] + 1, before[1] + 1, before[2])
        assert torch.equal(gk, pk) and torch.equal(gv, pv)
        assert torch.equal(gk, sk) and torch.equal(gv, sv)
    assert torch.equal(outs[0], want) and torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0].float(), ref.float(), rtol=0,
                               atol=2e-2 if q.dtype == torch.bfloat16 else 1e-4)


def _window_step(g, cuda, b, nq, h, smax, d, dtype):
    kc, vc = (torch.randn(b, h, smax, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    qkv = torch.randn(b, nq, 3 * h, d, generator=g, device=cuda).to(dtype)
    return kc, vc, qkv[:, :, :h].contiguous(), qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 64, 90])
@pytest.mark.parametrize("nq", [1, 3, 8])
def test_window_append_fused_at_the_flagship(cuda, nq, d, dtype):
    """K6's fused form at run (b)'s cache (4, 32, 328, D): the tensor-core
    form in bf16 at D = 128 and 64, the CUDA-core form in fp32 and at
    D = 90; the window's rows at write indices in the middle, at a tile's
    edge, at Smax - NQ, past it (the window shifts back whole, the mask
    keeps the raw index), negative (rows land at the end, the read sees
    the prefix's first slots or none), and at B = 1."""
    g = torch.Generator(device=cuda).manual_seed(nq + d)
    kc, vc, q, kn, vn = _window_step(g, cuda, 4, nq, 32, 328, d, dtype)
    for widx in ([256, 31 - nq // 2, 328 - nq, 327], [-1, -nq - 3, 340, 128 - nq],
                 [-328, 0, 95, 5]):
        _check_window_append(kc, vc, q, kn, vn, widx)
    _check_window_append(kc[:1], vc[:1], q[:1], kn[:1], vn[:1], [200])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_append_fused_several_tiles_a_warp(cuda, dtype):
    """K6's fused form over Smax 2100 (bf16: 6 warps of 11 tiles, a double
    buffer each): windows that straddle two tiles (two warps), in a warp's
    later tiles, at the end and negative."""
    g = torch.Generator(device=cuda).manual_seed(2100)
    kc, vc, q, kn, vn = _window_step(g, cuda, 2, 8, 2, 2100, 128, dtype)
    for widx in ([2092, 700], [28, 1000], [-1, 2099], [-2000, 222]):
        _check_window_append(kc, vc, q, kn, vn, widx)


# ---- the servers' slot pool and prefix refill ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,h,smax,d", [(4, 32, 337, 128), (8, 32, 401, 128), (2, 4, 81, 16)])
def test_decode_append_fused_pool_rows(cuda, b, h, smax, d):
    """K1's fused form at a server pool's ragged rows: each slot at its own
    write index with ``kv_len = write + 1``, idle slots clamped to the last
    slot (``kv_len == Smax``), over an Smax that is not a multiple of 32
    (B = 2, H = 4: the heads split over a cluster); the caches bit-equal to
    ``kv_append_plain``'s, the output within 2e-2 of the plain version, one
    launch of form "append"."""
    g = torch.Generator(device=cuda).manual_seed(smax)
    q, kc, vc = _k1_inputs(g, cuda, b, h, smax, d, torch.bfloat16)
    kn, vn = (torch.randn(b, h, 1, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    widx = [smax - 1, 0, 130, smax - 1, 5, 300, 77, smax - 2][:b]
    w = torch.tensor(widx, dtype=torch.int32, device=cuda)
    n = w + 1
    rk, rv = kc.clone(), vc.clone()
    ref = pdec.decode_attention_append_plain(q, rk, rv, kn, vn, w, n)
    before = (pdec.K1.launches, pdec.K1.forms.get("append", 0))
    got = pdec.decode_attention_append(q, kc, vc, kn, vn, w, n)
    assert (pdec.K1.launches, pdec.K1.forms.get("append", 0)) == (before[0] + 1, before[1] + 1)
    assert torch.equal(kc, rk) and torch.equal(vc, rv)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=0)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@pytest.mark.cuda
def test_decode_window_past_eight_on_the_card(cuda):
    """A 64-token window through ``llm_decode_step`` on a pair cache (the
    prefix refill's route past K6's 8, ``kv_len`` clamped for the second
    row's padding) on the card equals the same step on the CPU at the tiny
    config in fp32: hidden states and caches within 1e-4."""
    from mmmm_tpu_torch import MMMMConfig, init_params
    from mmmm_tpu_torch.models.cogvlm import decoder

    cfg = MMMMConfig.tiny()
    llm = init_params(cfg, 0, torch.float32, "cpu")["cogvlm"]["llm"]
    g = torch.Generator().manual_seed(0)
    b, p, s, smax = 2, 40, 64, 128
    emb, x = (torch.randn(b, n, cfg.vlm.hidden_size, generator=g) * 0.02 for n in (p, s))
    pos = torch.arange(p, dtype=torch.int32).expand(b, p)
    wpos = p + torch.arange(s).expand(b, s)
    sfx = torch.tensor([s, 37], dtype=torch.int32)
    kv_len = (p + torch.minimum(torch.arange(s)[None], sfx[:, None] - 1) + 1).to(torch.int32)
    write = torch.full((b,), p, dtype=torch.int32)
    out = []
    for dev in ("cpu", cuda):
        params = _to(llm, dev)
        _, caches = decoder.llm_prefill(params, cfg.vlm, emb.to(dev), torch.zeros_like(pos).to(dev),
                                        pos.to(dev), torch.ones_like(pos).to(dev), smax=smax)
        h, caches = decoder.llm_decode_step(params, cfg.vlm, x.to(dev), wpos.to(dev), caches,
                                            write.to(dev), kv_len.to(dev))
        out.append((h.cpu(), [t.cpu() for layer in caches for t in layer]))
    (ref, ref_caches), (got, got_caches) = out
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    for tg, tc in zip(got_caches, ref_caches):
        torch.testing.assert_close(tg, tc, atol=1e-4, rtol=0)


# ---- the reference's non-default numeric switches: K4's fast softmax, K9's bf16 cast -----

# K4's fast softmax is held to its plain fast form in the kernel's order of
# key tiles (dense_attention_fast_tiles). fp32 sums in other orders, and a
# logit within fp32 noise of a bf16 boundary of s - m (one probability moves
# by up to 2^-8 |s - m| p), move outputs by about 2e-7 in the mean and at
# most 9.8e-4 (one bf16 step) / 2.3e-4 (fp32 at the SAM shape), measured on
# the CPU with fp64 against fp32 logits; the limits: FAST_MEAN_TOL in the
# mean and FAST_TOL of the largest output. The exact softmax sits 1.3e-4 to
# 3.8e-4 away in the mean, so the default form misses the mean limit.
FAST_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-3}
FAST_MEAN_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype", [
    (4, 1153, 16, 112, torch.bfloat16),  # the ViT
    (4, 512, 12, 64, torch.float32),  # the SAM encoder
    (2, 77, 4, 88, torch.bfloat16),  # a ragged last tile
    (2, 33, 2, 8, torch.float32),
])
def test_dense_attention_fast_softmax(cuda, b, s, h, d, dtype):
    """K4's fast-softmax form (and so K12's) against its plain version in
    the kernel's order of key tiles, within ``FAST_TOL`` of the largest
    output and ``FAST_MEAN_TOL`` in the mean, twice bit for bit, one launch
    of form "fast"; the exact form's output misses the mean limit."""
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    scale = d ** -0.5
    before = (pdense.K4.launches, pdense.K4.forms.get("fast", 0))
    got = pdense.dense_attention(q, k, v, scale, fast_softmax=True)
    assert (pdense.K4.launches, pdense.K4.forms.get("fast", 0)) == (before[0] + 1, before[1] + 1)
    ref = pdense.dense_attention_fast_tiles(q, k, v, scale)
    top = ref.float().abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=FAST_TOL[dtype] * top)
    assert (got.float() - ref.float()).abs().mean().item() <= FAST_MEAN_TOL
    assert torch.equal(got, pdense.dense_attention(q, k, v, scale, fast_softmax=True))
    exact = pdense.dense_attention(q, k, v, scale)
    assert (exact.float() - ref.float()).abs().mean().item() > 4 * FAST_MEAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("smax", [320, 321])
def test_q8_bf16_cast_at_the_flagship_shape(cuda, smax, dtype):
    """K9 with ``cast="bf16"`` at H = 32, D = 128 for kv_len 1, 193, 256, 320
    and 0 over Smax 320 and 321 (the whole read: one chunk, so the row's max
    as the plain version takes it): within 2e-2 (bf16 q) / 1e-4 (fp32 q) of
    the plain version, zeros at kv_len 0, twice bit for bit, one launch of
    form "bf16"; the fp32 form differs from it."""
    g = torch.Generator(device=cuda).manual_seed(smax)
    b, h, d = 5, 32, 128
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([1, 193, 256, 320, 0], dtype=torch.int32, device=cuda)
    before = (pdec.K9.launches, pdec.K9.forms.get("bf16", 0))
    got = pdec.decode_attention_q8(q, kq, ks, vq, vs, kv_len, cast="bf16", q8_mxu=True)
    assert (pdec.K9.launches, pdec.K9.forms.get("bf16", 0)) == (before[0] + 1, before[1] + 1)
    want = pdec.decode_attention_q8_plain(q, kq, ks, vq, vs, kv_len, cast="bf16")
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.all(got[4] == 0)
    assert torch.equal(got, pdec.decode_attention_q8(q, kq, ks, vq, vs, kv_len, cast="bf16"))
    assert not torch.equal(got, pdec.decode_attention_q8(q, kq, ks, vq, vs, kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 90])
def test_q8_bf16_cast_through_the_ring(cuda, d, dtype):
    """K9 in bf16 over Smax 4096, where a head streams through the ring in
    chunks and each chunk's weights round against the running max (the
    reference's blocks do too): within 2e-2 / 1e-3 of the plain version."""
    smax = 4096
    g = torch.Generator(device=cuda).manual_seed(d)
    b, h = 3, 8
    kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=g, device=cuda))
    q = torch.randn(b, 1, h, d, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([4096, 1000, 3], dtype=torch.int32, device=cuda)
    got = pdec.decode_attention_q8(q, kq, ks, vq, vs, kv_len, cast="bf16")
    want = pdec.decode_attention_q8_plain(q, kq, ks, vq, vs, kv_len, cast="bf16")
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("smax", [320, 321])
def test_q8_bf16_cast_append_fused(cuda, smax, dtype):
    """K9's fused form in bf16 at B = 4 and B = 1, H = 32, D = 128, at every
    write-index edge: caches bit-equal to the appends', the output K8 then
    the bf16 read's bit for bit, and within the read's tolerance of the
    plain sequence."""
    g = torch.Generator(device=cuda).manual_seed(smax + 7)
    q, cache, kn, vn = _q8_step(g, cuda, 4, 32, smax, 128, dtype)
    for widx, lens in Q8_EDGES:
        _check_q8_append(cache, q, kn, vn, widx, lens, False, cast="bf16")
    for widx, lens in (([255], [256]), ([smax - 1], [0]), ([-3], [smax])):
        _check_q8_append({k: t[:1] for k, t in cache.items()}, q[:1], kn[:1], vn[:1], widx,
                         lens, False, cast="bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,q,kind", [(32, 24, 100, "random"), (32, 24, 100, "padded"),
                                        (32, 24, 100, "int"), (32, 8, 8, "random"),
                                        (32, 1, 100, "random"), (8, 32, 900, "random")])
def test_lap_kernel(cuda, n, k, q, kind):
    """LAP's col4row bit-equal to its plain version (twice) on the card."""
    from mmmm_tpu_torch.ops import hungarian as hg

    g = torch.Generator(device=cuda).manual_seed(0)
    if kind == "int":
        c = torch.randint(0, 4, (n, k, q), generator=g, device=cuda).float()
    else:
        c = torch.randn(n, k, q, generator=g, device=cuda)
        if kind == "padded":
            c[:, k // 2:] = 0.0
    before = hg.LAP.launches
    got = hg.lap_rectangular(c)
    assert hg.LAP.launches == before + 1
    assert torch.equal(got, hg.lap_rectangular(c))
    assert torch.equal(got, hg.lap_rectangular_plain(c))
    assert all(len(set(r.tolist())) == k for r in got)


@pytest.mark.cuda
def test_dense_attention_kernel_seg_exp_sam_shape(cuda):
    """K4 at the seg-exp SAM arm's encoder shape, (8, 1176, 8, 32) fp32."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(8, 1176, 8, 32, generator=g, device=cuda) for _ in range(3))
    torch.testing.assert_close(pdense.dense_attention(q, k, v, 32 ** -0.5),
                               pdense.dense_attention_plain(q, k, v, 32 ** -0.5),
                               atol=1e-4, rtol=0)
