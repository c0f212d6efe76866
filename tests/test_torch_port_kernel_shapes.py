"""The shapes the port's redesigned kernels take, on the CPU.

Each wrapper decides with a plain function whether its CUDA kernel takes a
shape (``ops/w4_matmul.py route``, ``mma_takes``, ``gemv_takes``;
``ops/attention.py kernel_head_dim`` for the attention kernels K3, K4, P1
and K7) and raises on a CUDA tensor of any other shape. These tests
enumerate the shapes the flagship's main paths hand them, so the card never
raises there:

  - every int4 product of the W4A16 prefill (``quantize_llm_for_serving(
    bits=4)`` weights) at B = 4, whole and in chunks of 2 samples, with the
    static expert span the serving path passes and with the masked dual
    path, recorded from the port's own ``llm_prefill`` over a one-layer
    flagship-width LLM whose int4 leaves are meta tensors;
  - every attention site of serving and of the training step (LLM, ViT over
    an fp32 and a bf16 image, SAM encoder) at the flagship and the tiny
    config, which the attention kernels take at their own head dim;

  - the launch shapes of the decode kernels: K6's form and warps a block
    (``ops/decode_kernel.py window_mma_takes``, ``window_warps``), K11's
    cluster over K at decode rows (``ops/w4_matmul.py gemv_cluster``) and
    K10's workspace (``q8_mxu_in_shared``), at run (b)'s and run (d)'s
    flagship shapes and the tiny and W4 test widths, and what each card
    wrapper passes its kernel there (the launch recorded, not run);
  - K9's and K10's staged read of the int8 cache: how it copies a head's
    slab (``q8_slab_copy``: one bulk copy, or with a head and a tail) and
    whether it takes the head whole or through a ring, of how many stages
    (``q8_stage_plan``), at run (c)'s and run (d)'s flagship shapes and at
    unaligned, short and long caches; K9's plain version against both TPU
    forms of its kernel (the full read and the ragged one, in interpret
    mode) at head dims and cache lengths off the 16-byte pieces;

and check that the predicates refuse shapes the kernels cannot take. A head
dim the attention kernels take only through zero lanes (D = 100 in bf16, 90
in fp32) runs the plain versions through the same pad and slice as the
card (``with_padded_head``), held against the JAX package's Pallas kernels
in interpret mode. The plain ``_delta`` (K7delta's plain version) is held
against the JAX package's delta expression in ``_flash_bwd_impl``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu.ops import dense_attn as jdense
from mmmm_tpu.ops import flash as jflash
from mmmm_tpu.ops import quant as jquant
from mmmm_tpu_torch.models.cogvlm import decoder as pdec
from mmmm_tpu_torch.models.cogvlm.config import CogVLMConfig
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.ops import _cuda
from mmmm_tpu_torch.ops import attention as pattn
from mmmm_tpu_torch.ops import decode_kernel as pdk
from mmmm_tpu_torch.ops import dense_attn as pdense
from mmmm_tpu_torch.ops import flash as pflash
from mmmm_tpu_torch.ops import quant as pquant
from mmmm_tpu_torch.ops import w4_matmul as pw4
from mmmm_tpu_torch.params import _llm_spec

B, PROMPT, N_VIS = 4, 192, 146  # the flagship serving batch (chip_smoke.py)


def _one_layer_w4_llm(cfg: CogVLMConfig) -> dict:
    """The LLM layer tree of ``cfg`` at one layer: the leaves that
    ``quantize_llm_for_serving(bits=4)`` converts become ``{"q4", "s4"}``
    meta tensors of the int4 layout, the norms real ones."""
    spec = _llm_spec(dataclasses.replace(cfg, num_hidden_layers=1))["layers"]

    def int4(leaf):
        _, k, n = leaf.shape
        return {"q4": torch.empty((1, k // 2, n), dtype=torch.int8, device="meta"),
                "s4": torch.empty((1, k // pquant.INT4_GROUP, n), device="meta")}

    layers = {}
    for key, leaf in spec.items():
        if isinstance(leaf, dict):
            layers[key] = {k: int4(v) if k in pquant.MLP_QUANT_KEYS else v
                           for k, v in leaf.items()}
        elif key in pquant.LLM_QUANT_KEYS:
            layers[key] = int4(leaf)
        else:
            layers[key] = torch.ones(leaf.shape, dtype=torch.bfloat16)
    return layers


def _prefill_products(b: int, vis_span) -> set:
    """(M, K, N, group) of every int4 product of one flagship prefill layer
    over ``b`` samples, recorded at ``w4_matmul``."""
    cfg = CogVLMConfig.cogvlm17b()
    seen = set()

    def record(x, q4, s4):
        k = x.shape[1]
        seen.add((x.shape[0], k, q4.shape[1], k // s4.shape[0]))
        return torch.zeros((x.shape[0], q4.shape[1]), dtype=x.dtype)

    params = {"layers": _one_layer_w4_llm(cfg),
              "norm": torch.ones(cfg.hidden_size, dtype=torch.bfloat16)}
    tt = torch.zeros(b, PROMPT, dtype=torch.int64)
    tt[:, 1:1 + N_VIS] = pdec.VISION_TOKEN_TYPE
    pos = torch.arange(PROMPT)[None].expand(b, PROMPT)
    emb = torch.zeros(b, PROMPT, cfg.hidden_size, dtype=torch.bfloat16)
    mp = pytest.MonkeyPatch()
    mp.setattr(pquant, "w4_matmul", record)
    try:
        pdec.llm_prefill(params, dataclasses.replace(cfg, num_hidden_layers=1), emb, tt, pos,
                         torch.ones(b, PROMPT, dtype=torch.int32), smax=PROMPT + 1,
                         vis_span=vis_span)
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("b", [B, 2], ids=["whole", "chunk2"])
@pytest.mark.parametrize("vis_span", [(1, 1 + N_VIS), None], ids=["span", "dual"])
def test_w4a16_prefill_products_take_a_kernel(b, vis_span):
    products = _prefill_products(b, vis_span)
    # 5 projections (qkv, dense, gate, up, down) over the flagship's widths
    assert {(k, n) for _, k, n, _ in products} == {(4096, 12288), (4096, 4096), (4096, 11008),
                                                   (11008, 4096)}
    rows = {m for m, *_ in products}
    if vis_span is None:
        assert rows == {b * PROMPT}
    else:  # language [0, 1), vision [1, 146), language [146, 192) a sample
        assert rows == {b, b * (N_VIS - 1), b * (PROMPT - N_VIS)}
    for m, k, n, group in products:
        kernel = pw4.route(m, k, n, group, torch.bfloat16)
        assert kernel == ("K11mma" if m > pw4.GEMV_MAX_ROWS else "K11")
        assert pw4.route(m, k, n, group, torch.float32) == "K11"


@pytest.mark.parametrize("m", [5, 17, 64, 65, 92, 290, 292, 580, 584, 768])
def test_w4_mma_takes_the_flagship_row_counts(m):
    for k, n in ((4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096)):
        assert pw4.mma_takes(m, k, n, pquant.INT4_GROUP)
        assert pw4.gemv_takes(k, n, pquant.INT4_GROUP)


@pytest.mark.parametrize("m,n,tpw", [
    (290, 12288, 1), (290, 4096, 1), (290, 11008, 2),  # run (d)'s vision rows, a chunk of 2
    (92, 12288, 1), (92, 4096, 1), (92, 11008, 1),     # its text rows
    (580, 12288, 2), (580, 4096, 2), (580, 11008, 2),  # the whole batch's
    (184, 12288, 2), (184, 4096, 1), (184, 11008, 2),
    (584, 11008, 2), (17, 11008, 1), (290, 4224, 1),
])
def test_w4_mma_tile_width(m, n, tpw):
    """256-column blocks only where they take half as many waves over the
    132 SMs as 128-column blocks; the kernel takes the width it is given
    at every flagship N."""
    assert pw4.mma_tpw(m, n) == tpw
    assert n % (pw4.MMA_BN * tpw) == 0


@pytest.mark.parametrize("m,k,n,group", [
    (32, 4096, 4160, 128),   # N not a multiple of the 128-column tile
    (32, 4096, 4096, 32),    # a k-step of 64 packed rows would span scale groups
    (32, 4160, 4096, 128),   # K/2 not a multiple of the 64-row step
    (0, 4096, 4096, 128),
])
def test_w4_mma_refuses(m, k, n, group):
    assert not pw4.mma_takes(m, k, n, group)
    if m > pw4.GEMV_MAX_ROWS:
        with pytest.raises(ValueError):
            pw4.route(m, k, n, group, torch.bfloat16)


def test_w4_gemv_refuses():
    assert not pw4.gemv_takes(4096, 4104, 128)  # N % 16
    assert not pw4.gemv_takes(4096, 4096, 1024)  # group > 512
    assert not pw4.gemv_takes(4096, 4096, 48)  # group % 32
    with pytest.raises(ValueError):
        pw4.route(4, 4096, 4104, 128, torch.bfloat16)


def _training_sites(vlm: CogVLMConfig, sam: SamConfig):
    """(name, head dim, dtypes) of the training step's flash sites, which
    serving's K3 (LLM prefill) and K4 (ViT, SAM encoder) sites share: the
    LLM in bf16, the ViT in fp32 (an fp32 image, as the data loaders pass)
    and in bf16 (a bf16 image), the SAM encoder in fp32."""
    return [("llm", vlm.head_dim, (torch.bfloat16,)),
            ("vit", vlm.vision.hidden_size // vlm.vision.num_heads,
             (torch.float32, torch.bfloat16)),
            ("sam", sam.embed_dim // sam.encoder_num_heads, (torch.float32,))]


@pytest.mark.parametrize("which", ["flagship", "tiny"])
def test_training_flash_sites_take_k7(which):
    """The attention kernels (K3, K4, K7) take every site at its own head
    dim, with no pad."""
    if which == "flagship":
        vlm, sam = CogVLMConfig.cogvlm17b(), SamConfig()
        assert [d for _, d, _ in _training_sites(vlm, sam)] == [128, 112, 64]
    else:
        vlm, sam = CogVLMConfig.tiny(), SamConfig.tiny()
        assert [d for _, d, _ in _training_sites(vlm, sam)] == [16, 8, 8]
    for name, d, dtypes in _training_sites(vlm, sam):
        for dt in dtypes:
            assert pattn.kernel_head_dim(d, dt) == d, (name, d, dt)


@pytest.mark.parametrize("d,dtype", [(144, torch.bfloat16), (136, torch.bfloat16),
                                     (130, torch.float32), (129, torch.float32),
                                     (64, torch.float16), (0, torch.float32)])
def test_k7_refuses(d, dtype):
    """No attention kernel takes a head dim above 128 or another dtype."""
    assert pattn.kernel_head_dim(d, dtype) is None


@pytest.mark.parametrize("d,dtype,dp", [(100, torch.bfloat16, 104), (90, torch.float32, 92),
                                        (20, torch.bfloat16, 24), (6, torch.float32, 8),
                                        (1, torch.bfloat16, 8), (127, torch.float32, 128)])
def test_attention_kernels_take_other_head_dims_through_the_pad(d, dtype, dp):
    """A head dim that is not a whole number of 16-byte pieces runs at the
    next one, padded with zero lanes."""
    assert pattn.kernel_head_dim(d, dtype) == dp


def test_with_padded_head_pads_and_slices():
    """One zero-padded copy in, outputs of the operands' rank cut back to D;
    other outputs (lse) pass as they are."""
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    seen = []

    def fn(a):
        seen.append(a)
        return a * 2, a.sum(-1)

    out, other = pattn.with_padded_head(8, fn, x)
    assert seen[0].shape == (2, 3, 4, 8) and torch.all(seen[0][..., 6:] == 0)
    torch.testing.assert_close(out, x * 2, rtol=0, atol=0)
    assert out.is_contiguous() and other.shape == (2, 3, 4)


@pytest.mark.parametrize("d,dtype", [(136, torch.bfloat16), (130, torch.float32)])
def test_flash_attention_refuses_k7_head_dims_before_the_forward(monkeypatch, d, dtype):
    """On the card, a differentiable site whose head dim K7 cannot take
    raises in the forward (before K3), not in the backward; the card is
    stood in for by telling the wrapper its tensors are not on the CPU."""
    monkeypatch.setattr(pflash._cuda, "on_cpu", lambda name, t: False)
    q = torch.zeros(1, 16, 2, d, dtype=dtype, requires_grad=True)
    seg = torch.ones(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="K7 does not take"):
        pflash.flash_attention(q, q, q, seg, seg, causal=False, scale=0.1)


@pytest.mark.parametrize("d,dtype", [(88, torch.bfloat16), (8, torch.float32)])
def test_k7_takes_the_test_head_dims(d, dtype):
    assert pattn.kernel_head_dim(d, dtype) == d


# ---- the pad-and-slice route against the JAX package's kernels -----------------------

def _padded_inputs(d: int, dtype: str, seed: int):
    """B=2, S=150 (a partial last block), H=2; two packed segments in sample
    0, a padded tail in sample 1, and queries 80..84 of sample 0 whose
    segment has no key when causal. Values rounded to bf16 where bf16."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((2, 150, 2, d)).astype(np.float32) for _ in range(4))
    if dtype == "bfloat16":
        q, k, v, g = (np.asarray(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32))
                      for t in (q, k, v, g))
    seg = np.ones((2, 150), np.int32)
    seg[0, 80:] = 2
    seg[1, 120:] = 0
    kv_seg = seg.copy()
    kv_seg[0, 80:85] = 3
    return q, k, v, g, seg, kv_seg


def _pair(x, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, ref, frac):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=frac * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("d,dtype", [(100, "bfloat16"), (90, "float32")])
def test_padded_route_matches_pallas(d, dtype):
    """K4, K3 (out, lse) and K7 at a head dim they take only through the
    pad: the plain versions run at ``kernel_head_dim`` through
    ``with_padded_head`` (the card's route) against ``dense_attention``,
    ``_flash_fwd_impl`` and ``_flash_bwd_impl`` (interpret mode) at D.
    Tolerances: 2e-5 absolute in fp32 and 5e-2 in bf16 for the forward (the
    repo's attention tolerances), 1e-4 / 2e-2 of the largest gradient."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dp = pattn.kernel_head_dim(d, tdt)
    assert dp not in (None, d)
    q, k, v, g, seg, kv_seg = _padded_inputs(d, dtype, seed=d)
    (jq, pq), (jk, pk), (jv, pv), (jg, pg) = (_pair(t, dtype) for t in (q, k, v, g))
    fwd = 5e-2 if dtype == "bfloat16" else 2e-5
    scale = d ** -0.5

    got = pattn.with_padded_head(dp, lambda *t: pdense.dense_attention(*t, scale), pq, pk, pv)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jdense.dense_attention(jq, jk, jv, scale), np.float32),
                               rtol=0, atol=fwd)

    jseg, jkv, tseg, tkv = jnp.asarray(seg), jnp.asarray(kv_seg), torch.from_numpy(seg), \
        torch.from_numpy(kv_seg)
    for causal in (True, False):
        out, lse = pattn.with_padded_head(dp, lambda *t: pflash.flash_segment_attention(
            *t, tseg, tkv, causal=causal, scale=scale), pq, pk, pv)
        jout, jlse = jflash._flash_fwd_impl(jq, jk, jv, jseg, jkv, causal, scale, 128, 128)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), rtol=0,
                                   atol=fwd)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0, :150], rtol=0,
                                   atol=1e-3 if dtype == "bfloat16" else 2e-5)
        grads = pattn.with_padded_head(dp, lambda q_, k_, v_, o_, g_: (
            pflash.flash_segment_attention_bwd_plain(q_, k_, v_, tseg, tkv, o_, lse, g_,
                                                     causal=causal, scale=scale)),
            pq, pk, pv, out, pg)
        ref = jflash._flash_bwd_impl(jq, jk, jv, jseg, jkv, jout, jlse, jg, causal, scale, 128,
                                     128)
        for a, r in zip(grads, ref):
            assert a.shape == pq.shape and a.dtype == tdt
            _close(a, r, 2e-2 if dtype == "bfloat16" else 1e-4)
        if causal:  # query 80 of sample 0 and the padded tail see no key
            assert torch.all(out[0, 80] == 0) and torch.all(grads[0][0, 80] == 0)
            assert torch.all(out[1, 120:] == 0) and torch.all(grads[0][1, 120:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_matches_the_jax_expression(dtype):
    """``_delta(out, g)`` against ``_flash_bwd_impl``'s ``delta = sum(dO *
    O)`` over (B, H, S, D) in fp32, on seeded numpy inputs: sums of 112
    products in fp32 in another order."""
    rng = np.random.default_rng(0)
    g_np, o_np = (rng.standard_normal((2, 37, 3, 112)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    g_j, o_j = jnp.asarray(g_np).astype(jdt), jnp.asarray(o_np).astype(jdt)
    dot, ot = jnp.swapaxes(g_j, 1, 2), jnp.swapaxes(o_j, 1, 2)
    want = np.asarray(jnp.sum(dot.astype(jnp.float32) * ot.astype(jnp.float32), axis=-1))
    got = pflash._delta(torch.from_numpy(o_np).to(tdt), torch.from_numpy(g_np).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 37)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- the decode kernels' launch shapes (K6, K10, K11's decode rows) ----------------

WINDOW = 8  # run (b)'s verify window (7 drafts)
SMAX_SPEC = PROMPT + 128 + WINDOW  # run (b)'s cache: prompt, 128 new tokens, a window


@pytest.mark.parametrize("smax,warps", [
    (SMAX_SPEC, (11, 1)),  # run (b) at the flagship: a warp for each of 11 tiles
    (40, (2, 1)),          # the tiny config's spec cache
    (384, (12, 1)),
    (385, (6, 3)),         # past 12 tiles: 6 warps walk them with a double buffer
    (2100, (6, 11)),
])
def test_window_warps(smax, warps):
    got = pdk.window_warps(smax)
    assert got == warps
    n, per = got
    assert n * per * pdk.WINDOW_TILE_KEYS >= smax > (n * per - n) * pdk.WINDOW_TILE_KEYS
    # the tiles' K and V at D = 128 (rows of 136 bf16) fit in a block's shared memory
    assert min(per, 2) * n * 2 * 32 * 136 * 2 <= 227 * 1024


def test_window_form_by_dtype_and_head_dim():
    """The tensor-core form in bf16 at every head dim that is whole 16-byte
    rows (the flagship's 128, the W4 widths' 64, the tiny config's 16); the
    CUDA-core form in fp32 and at D = 90."""
    for d in (CogVLMConfig.cogvlm17b().head_dim, 64, 16, 8, 120):
        assert pdk.window_mma_takes(torch.bfloat16, d)
        assert not pdk.window_mma_takes(torch.float32, d)
    assert CogVLMConfig.cogvlm17b().head_dim == 128 and CogVLMConfig.tiny().head_dim == 16
    assert not pdk.window_mma_takes(torch.bfloat16, 90)
    assert not pdk.window_mma_takes(torch.bfloat16, 136)


@pytest.mark.parametrize("k,n,cluster", [
    (4096, 12288, 2), (4096, 4096, 2), (4096, 11008, 2), (11008, 4096, 2),  # the flagship
    (256, 768, 1), (256, 256, 1), (256, 512, 1), (512, 256, 1),  # the W4 test widths
])
def test_gemv_cluster(k, n, cluster):
    """K11's decode rows: a cluster of 2 blocks a 64-column tile wherever
    each of its 16 warps gets a 32-row iteration."""
    assert pw4.gemv_cluster(k, n) == cluster
    assert pw4.gemv_takes(k, n, pquant.INT4_GROUP)
    iters = (k // 2) // pw4.GEMV_ITER
    assert iters >= pw4.GEMV_WARPS * cluster or cluster == 1
    if k >= 4096:  # the flagship's tiles fill the H100's 132 SMs at least once
        assert -(-n // pw4.GEMV_COLS) * cluster >= pw4.H100_SMS - 4


@pytest.fixture
def recorded(monkeypatch):
    """The card path of the decode wrappers on meta or CPU tensors: every
    tensor counts as a CUDA tensor and each kernel call is recorded, not
    run: its arguments, then the launch's ``form=`` keyword (None where it
    has none)."""
    calls = {}
    monkeypatch.setattr(_cuda, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(_cuda, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    for mod, name in ((pdk, "K6"), (pdk, "K9"), (pdk, "K10"), (pw4, "K11")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw: calls.setdefault(_n, []).append(
            (*a, kw.get("form"))))
    return calls


def test_window_wrapper_launch(recorded):
    meta = dict(device="meta")
    q = torch.empty(B, WINDOW, 32, 128, dtype=torch.bfloat16, **meta)
    kc = torch.empty(B, 32, SMAX_SPEC, 128, dtype=torch.bfloat16, **meta)
    w = torch.empty(B, dtype=torch.int32, **meta)
    pdk.decode_attention_window(q, kc, kc, w)
    assert recorded["K6"][-1][11:14] == (1, 11, 1)  # bf16, 11 warps of one tile
    pdk.decode_attention_window(q.float(), kc.float(), kc.float(), w)
    assert recorded["K6"][-1][11:14] == (0, 0, 0)  # the CUDA-core form
    q90, k90 = (torch.empty(*t.shape[:-1], 90, dtype=torch.bfloat16, **meta) for t in (q, kc))
    pdk.decode_attention_window(q90, k90, k90, w)
    assert recorded["K6"][-1][11:14] == (1, 0, 0)
    assert all(args[-1] is None for args in recorded["K6"])  # the read alone


def test_fused_window_launch_takes_the_rows_as_they_are(recorded):
    """The verify step launches K6 once in its form ``"append"``: the
    tensor-core form (bf16, D = 128) with the rows' strides where every row
    starts on 16 bytes; rows that do not are first copied into an aligned
    tensor; the CUDA-core form (fp32) takes any strides."""
    meta = dict(device="meta")
    h, d = 32, 128
    qkv = torch.empty(B, WINDOW, 3 * h, d, dtype=torch.bfloat16, **meta)
    q, kn, vn = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    kc = torch.empty(B, h, SMAX_SPEC, d, dtype=torch.bfloat16, **meta)
    w = torch.empty(B, dtype=torch.int32, **meta)
    pdk.decode_attention_window_append(q, kc, kc, kn, vn, w)
    args = recorded["K6"][-1]
    assert args[-1] == "append" and args[11:14] == (1, 11, 1)
    assert args[16:22] == (WINDOW * 3 * h * d, 3 * h * d, d) * 2
    odd = torch.empty(B, WINDOW, h, d + 4, dtype=torch.bfloat16, **meta)[..., 2:d + 2]
    pdk.decode_attention_window_append(q, kc, kc, odd, odd, w)
    args = recorded["K6"][-1]
    assert args[16:22] == (WINDOW * h * d, h * d, d) * 2  # copied: rows now start on 16 bytes
    qf, kf = q.float(), kc.float()
    of = torch.empty(B, WINDOW, h, d + 4, **meta)[..., 2:d + 2]
    pdk.decode_attention_window_append(qf, kf, kf, of, of, w)
    args = recorded["K6"][-1]
    assert args[11:14] == (0, 0, 0)
    assert args[16:22] == (WINDOW * h * (d + 4), h * (d + 4), d + 4) * 2
    assert [args[-1] for args in recorded["K6"]] == ["append"] * 3


@pytest.mark.parametrize("h,smax,d,shared", [
    (32, PROMPT + 128, 128, True),  # run (d) at the flagship
    (4, 64, 48, True), (4, 64, 80, True), (4, 64, 100, True),  # head dims off the 16-byte lanes
    (3, 40000, 16, False),  # Smax past shared memory, where the reference's gate admits it
])
def test_q8_mxu_takes_what_the_reference_takes(recorded, h, smax, d, shared):
    """K10 no longer refuses a head dim outside {16, 32, 64, 128} or an
    Smax above 32768: ``decode_attention_q8(q8_mxu=True)`` launches it
    wherever ``_q8_mxu_eligible`` holds, with a workspace where the logits
    do not fit in shared memory."""
    assert pdk._q8_mxu_eligible(h, smax, d)
    assert pdk.q8_mxu_in_shared(smax) == shared
    meta = dict(device="meta")
    q = torch.empty(1, 1, h, d, dtype=torch.bfloat16, **meta)
    kq = torch.empty(1, h, smax, d, dtype=torch.int8, **meta)
    ks = torch.empty(1, h, smax, 1, dtype=torch.bfloat16, **meta)
    n = torch.empty(1, dtype=torch.int32, **meta)
    pdk.decode_attention_q8(q, kq, ks, kq, ks, n, q8_mxu=True)
    args = recorded["K10"][-1]
    assert args[8:12] == (1, h, smax, d)
    assert (args[7] is None) == shared


@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096)])
def test_w4_decode_rows_launch(recorded, k, n):
    """Run (d)'s decode products (M = 4): bf16 x takes K11 in one launch
    with no workspace and the cluster ``gemv_cluster`` picks; fp32 x keeps
    the group-sum workspace."""
    meta = dict(device="meta")
    q4 = torch.empty(k // 2, n, dtype=torch.int8, **meta)
    s4 = torch.empty(k // pquant.INT4_GROUP, n, **meta)
    before = pw4.K11_BY_SHAPE[(k, n)]
    for m in (1, 4, 16):
        pw4.w4_matmul(torch.empty(m, k, dtype=torch.bfloat16, **meta), q4, s4)
        args = recorded["K11"][-1]
        assert args[4] is None and args[5:12] == (m, k, n, pquant.INT4_GROUP, 1,
                                                   pw4.gemv_cluster(k, n), 0)
    pw4.w4_matmul(torch.empty(4, k, **meta), q4, s4)
    args = recorded["K11"][-1]
    assert args[4] is not None and args[9:11] == (0, 1)
    assert pw4.K11_BY_SHAPE[(k, n)] - before == 4  # each launch counted on its shape


# ---- K9's and K10's staged read of the int8 cache ------------------------------------

SMAX_Q8 = PROMPT + 128  # runs (c) and (d): the prompt and 128 new tokens


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("d", [8, 90, 100, 128])
@pytest.mark.parametrize("smax", [57, SMAX_Q8, 321, 4096, 40000])
def test_q8_stage_plan(smax, d, mxu):
    """The whole head at once (two stages of roundup(Smax, 16) slots: K and
    V both requested as the block starts) wherever that fits beside the
    kernel's own shared memory, else the largest ring of 4 stages of a
    multiple of 16 slots that fits."""
    chunk, stages = pdk.q8_stage_plan(smax, d, mxu=mxu)
    used = lambda c, n: n * pdk.q8_stage_bytes(c, d) + pdk.q8_math_smem(smax, c, mxu)
    assert chunk % 16 == 0 and used(chunk, stages) <= pdk.Q8_DYNAMIC_SMEM
    whole = smax <= 321 or (smax == 4096 and d == 8)
    if whole:
        assert (chunk, stages) == (-(-smax // 16) * 16, 2)
    else:
        assert stages == 4 and 16 <= chunk < smax
        assert used(chunk + 16, stages) > pdk.Q8_DYNAMIC_SMEM
    # the kernels' static arrays (at most 4.2 KiB) fit beside it in the H100's 227 KiB
    assert pdk.Q8_DYNAMIC_SMEM + 4352 <= 232448


def test_q8_stage_plan_at_the_flagship():
    """Runs (c) and (d) (Smax 320, D = 128): all of a head's K and V rows
    and scales in two stages, 83 KiB a block with K9's chunk logits and
    K10's slot logits and split weights; K10's workspace only past
    ``Q8_MXU_SHARED_SLOTS``."""
    d = CogVLMConfig.cogvlm17b().head_dim
    for mxu, math in ((False, 8 * SMAX_Q8), (True, 6 * SMAX_Q8)):
        assert pdk.q8_stage_plan(SMAX_Q8, d, mxu=mxu) == (SMAX_Q8, 2)
        assert pdk.q8_math_smem(SMAX_Q8, SMAX_Q8, mxu) == math
    assert 2 * pdk.q8_stage_bytes(SMAX_Q8, d) == 2 * (40976 + 656)
    assert pdk.q8_mxu_in_shared(pdk.Q8_MXU_SHARED_SLOTS)
    assert not pdk.q8_mxu_in_shared(pdk.Q8_MXU_SHARED_SLOTS + 1)


@pytest.mark.parametrize("offset,nbytes,split", [
    (0, 256 * 128, (0, 32768, 0)),   # a flagship head's K rows at kv_len 256: one bulk copy
    (640, 512, (0, 512, 0)),          # its scales
    (640, 386, (0, 384, 2)),          # the scales at kv_len 193: a tail
    (642, 642, (14, 624, 4)),         # Smax 321, head 1's scales: a head and a tail
    (2 * 57 * 90, 23 * 90, (12, 2048, 10)),  # D = 90: rows 57 * 90 bytes apart
    (10, 10, (6, 0, 4)),              # crosses a boundary, no whole piece
    (2, 8, (8, 0, 0)),                # inside one piece
    (16, 0, (0, 0, 0)),               # kv_len 0
])
def test_q8_slab_copy(offset, nbytes, split):
    assert pdk.q8_slab_copy(offset, nbytes) == split


@pytest.mark.parametrize("d", [8, 90, 100, 128])
@pytest.mark.parametrize("smax", [57, SMAX_Q8, 321])
def test_q8_slab_copy_covers_every_head(smax, d):
    """Every head's rows and scales at the flagship batch (B = 4, H = 32)
    and every kv_len: the pieces cover the slab exactly, the body is whole
    aligned 16-byte pieces, and head and tail are under 16 bytes. Where
    ``Smax * D`` and ``2 Smax`` are multiples of 16 (the flagship's 320 x 128)
    every slab of rows is one bulk copy."""
    for bh in range(B * 32):
        for n in (0, 1, 17, 193, 256, smax):
            n = min(n, smax)
            for offset, nbytes in ((bh * smax * d, n * d), (bh * smax * 2, n * 2)):
                head, body, tail = pdk.q8_slab_copy(offset, nbytes)
                assert head + body + tail == nbytes and head < 16 and tail < 16
                assert body % 16 == 0 and (body == 0 or (offset + head) % 16 == 0)
                assert head == 0 or (offset + head) % 16 == 0 or tail == 0
            if smax * d % 16 == 0:
                assert pdk.q8_slab_copy(bh * smax * d, n * d) == (0, n * d - n * d % 16,
                                                                  n * d % 16)
    if smax == SMAX_Q8 and d == 128:
        assert all(pdk.q8_slab_copy(bh * smax * d, n * d)[::2] == (0, 0)
                   for bh in range(B * 32) for n in range(smax + 1))


@pytest.mark.parametrize("smax,d", [(SMAX_Q8, 128), (321, 128), (57, 90), (4096, 128),
                                    (40000, 16)])
def test_q8_wrappers_launch(recorded, smax, d):
    """What K9 and K10 are handed on the card: the plan of their staged read
    (run (c)'s and run (d)'s flagship cache: two stages of 320 slots)."""
    meta = dict(device="meta")
    h = 32 if smax < 40000 else 3
    q = torch.empty(B, 1, h, d, dtype=torch.bfloat16, **meta)
    kq = torch.empty(B, h, smax, d, dtype=torch.int8, **meta)
    ks = torch.empty(B, h, smax, 1, dtype=torch.bfloat16, **meta)
    n = torch.empty(B, dtype=torch.int32, **meta)
    pdk.decode_attention_q8(q, kq, ks, kq, ks, n)
    assert recorded["K9"][-1][9:11] == (smax, d)
    assert recorded["K9"][-1][13:15] == pdk.q8_stage_plan(smax, d)
    pdk.decode_attention_q8_mxu(q, kq, ks, kq, ks, n)
    assert recorded["K10"][-1][10:12] == (smax, d)
    assert recorded["K10"][-1][14:16] == pdk.q8_stage_plan(smax, d, mxu=True)
    if smax == SMAX_Q8:
        assert recorded["K9"][-1][13:15] == recorded["K10"][-1][14:16] == (320, 2)


@pytest.mark.parametrize("mxu,kid,at", [(False, "K9", 15), (True, "K10", 16)])
def test_fused_q8_launch_reads_the_projection_strides(recorded, mxu, kid, at):
    """The int8 step launches K9 (or K10 under ``q8_mxu``) once, in its form
    ``"append"``, under the read's plan, with the new rows' own strides over
    b and h (views of a fused (B, 1, 3H, D) projection: no copy, no
    transpose). Where D % 16 == 0 the kernel reads a row by 16-byte pieces,
    so rows that do not start on 16 bytes are first copied into an aligned
    tensor; at D = 90 they are taken as they are."""
    meta = dict(device="meta")
    h = 32

    def launch(d, kn, vn):
        qkv = torch.empty(B, 1, 3 * h, d, dtype=torch.bfloat16, **meta)
        cache = {"kq": torch.empty(B, h, SMAX_Q8, d, dtype=torch.int8, **meta),
                 "ks": torch.empty(B, h, SMAX_Q8, 1, dtype=torch.bfloat16, **meta)}
        cache.update(vq=cache["kq"], vs=cache["ks"])
        n = torch.empty(B, dtype=torch.int32, **meta)
        kn, vn = (qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]) if kn is None else (kn, vn)
        pdk.decode_attention_q8_append(qkv[:, :, :h], cache, kn, vn, n, n, q8_mxu=mxu)
        args = recorded[kid][-1]
        assert args[-1] == "append" and args[at - 2:at] == pdk.q8_stage_plan(SMAX_Q8, d, mxu=mxu)
        return args[at + 3:at + 7]  # k_sb, k_sh, v_sb, v_sh

    assert launch(128, None, None) == (3 * h * 128, 128, 3 * h * 128, 128)
    for d, copied in ((128, True), (90, False)):
        odd = torch.empty(B, 1, h, d + 4, dtype=torch.bfloat16, **meta)[..., 2:d + 2]
        assert launch(d, odd, odd) == ((h * d, d) if copied else (h * (d + 4), d + 4)) * 2
    assert len(recorded[kid]) == 3


def _q8_case(rng, b, h, smax, d, bf16):
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    if bf16:
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    return q, [kq, ks, vq, vs]


def _torch_of(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("smax,d,block_s", [(57, 90, 19), (40, 100, 8), (64, 8, 16),
                                            (48, 128, 16)])
def test_q8_plain_matches_both_pallas_forms(smax, d, block_s, bf16):
    """K9's plain version against the full-read Pallas kernel
    (``_decode_attention_pallas_q8_full``) and the ragged one
    (``decode_attention_pallas_q8_ragged``), in interpret mode, at head dims
    off the 16-byte pieces and an unaligned Smax: atol 1e-5 in fp32, 2e-2
    in bf16 (the Pallas kernels' sums run in another order)."""
    rng = np.random.default_rng(smax + d)
    b, h = 3, 4
    q, leaves = _q8_case(rng, b, h, smax, d, bf16)
    kv_len = np.array([0, smax // 2 + 1, smax], np.int32)
    jq = jnp.asarray(q, jnp.bfloat16 if bf16 else jnp.float32)
    pq = torch.from_numpy(q).to(torch.bfloat16 if bf16 else torch.float32)
    got = pdk.decode_attention_q8(pq, *map(_torch_of, leaves), torch.from_numpy(kv_len))
    assert torch.all(got[0] == 0)
    tol = dict(atol=2e-2 if bf16 else 1e-5, rtol=0)
    full = jdec._decode_attention_pallas_q8_full(jq, *leaves, jnp.asarray(kv_len),
                                                 scale=d ** -0.5)
    ragged = jdec.decode_attention_pallas_q8_ragged(jq, *leaves, jnp.asarray(kv_len),
                                                    block_s=block_s, cast="f32")
    for ref in (full, ragged):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


# ---- the kernel forms of the reference's numeric switches ------------------------------

@pytest.mark.parametrize("b,s,h,d,dtype", [(4, 1153, 16, 112, torch.bfloat16),
                                           (4, 512, 12, 64, torch.float32),
                                           (4, 1153, 16, 100, torch.bfloat16)])
def test_dense_fast_softmax_launch(recorded, monkeypatch, b, s, h, d, dtype):
    """K4's fast softmax at the ViT's and the SAM encoder's shapes (and
    through the zero-lane pad): one launch of the same entry point, its
    ``fast`` argument 1 and its form "fast", at the head dim the kernel
    takes; the default form passes 0 and no form."""
    calls = []
    monkeypatch.setattr(pdense, "K4", lambda *a, **kw: calls.append((*a, kw.get("form"))))
    q = torch.empty(b, s, h, d, dtype=dtype, device="meta")
    pdense.dense_attention(q, q, q, 0.1, fast_softmax=True)
    pdense.dense_attention(q, q, q, 0.1)
    dp = pattn.kernel_head_dim(d, dtype)
    assert [c[4:8] for c in calls] == [(b, s, h, dp)] * 2
    assert [c[-4:] for c in calls] == [(int(dtype == torch.bfloat16), 1, 0, "fast"),
                                       (int(dtype == torch.bfloat16), 0, 0, None)]


def test_q8_bf16_cast_launch(recorded):
    """K9 with ``cast="bf16"`` at run (c)'s flagship cache (H = 32, Smax
    320, D = 128): the read alone and the fused step each one launch under
    the same plan, the cast argument 1, forms "bf16" and ("append",
    "bf16"); ``q8_mxu`` does not take K10 then (the reference's ragged
    route never takes the split-int8 read)."""
    meta = dict(device="meta")
    h, d = 32, 128
    q = torch.empty(B, 1, h, d, dtype=torch.bfloat16, **meta)
    kq = torch.empty(B, h, SMAX_Q8, d, dtype=torch.int8, **meta)
    ks = torch.empty(B, h, SMAX_Q8, 1, dtype=torch.bfloat16, **meta)
    n = torch.empty(B, dtype=torch.int32, **meta)
    pdk.decode_attention_q8(q, kq, ks, kq, ks, n, cast="bf16", q8_mxu=True)
    pdk.decode_attention_q8_append(q, {"kq": kq, "ks": ks, "vq": kq, "vs": ks}, q, q, n, n,
                                   cast="bf16", q8_mxu=True)
    pdk.decode_attention_q8(q, kq, ks, kq, ks, n)
    assert "K10" not in recorded and len(recorded["K9"]) == 3
    plan = pdk.q8_stage_plan(SMAX_Q8, d)
    for args, form, cast in zip(recorded["K9"], ["bf16", ("append", "bf16"), None], [1, 1, 0]):
        assert args[9:11] == (SMAX_Q8, d) and args[13:15] == plan
        assert args[-1] == form and args[-3] == cast
    with pytest.raises(ValueError, match="cast"):
        pdk.decode_attention_q8(q, kq, ks, kq, ks, n, cast="fp16")
