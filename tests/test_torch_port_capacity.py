"""The port's third slice, capacity serving, against the JAX package on the
CPU: the split-int8 decode read (K10), K4 as the counterpart of the
layout-native K12 and its softmax-free floor P1, the instance-SAM head, and
``generate_grounded`` with ``instance``, ``prefill_chunk`` (both modes,
greedy and speculative), W8A8 decode and prefill, ``sam_bf16``, and W4A16
weights read through the split-int8 kernel.

Tolerances, each with its reason:

- ``q14_split`` bit-equal (the same fp32 division and round-half-even).
- K10's plain version against the Pallas kernel (interpret mode): atol 1e-5.
  The integer dots are exact; ``exp`` and the softmax sums round in another
  order, which can move a 14-bit weight by one step (about 1e-6 here). In
  the band where the int32 sums wrap (kv_len > 1040, uniform attention)
  both are exact and bit-equal.
- K4 against ``_dense_fwd_bshd`` (interpret): 1e-5 in fp32, one bf16 step
  (2**-7 at |o| < 2) in bf16; P1 against a numpy transcription of the
  probe's ``_kernel_nosm``: 1e-6 in fp32, one bf16 step in bf16.
- ``instance_sam_forward`` boxes, presence logits and masks: atol 1e-5
  (fp32, as tests/test_torch_port_models.py).
- ``generate_grounded``: tokens, texts and targets identical; masks within
  2e-4 (tests/test_serving.py's tolerance), or 2**-4 of the largest mask
  logit with the SAM head in bf16; boxes and presence logits within 1e-4
  (the same hidden states through the box head's three layers).

The JAX reference reads its serving switches from the environment
(``MMMM_PREFILL_CHUNK_MODE``, ``MMMM_W8A8``, ``MMMM_W8A8_PREFILL``,
``MMMM_Q8_MXU``, ``MMMM_SAM_BF16``) at trace time; its stage caches are cleared around every
such run, since ``MMMM_W8A8_PREFILL`` and ``MMMM_Q8_MXU`` are not part of
their keys.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.data.tokenizer import MMMMTokenizer as JaxTokenizer
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import inference as jinf
from mmmm_tpu.models.cogvlm import CogVLMConfig as JaxCogVLMConfig
from mmmm_tpu.models.cogvlm.config import VisionConfig as JaxVisionConfig
from mmmm_tpu.models.segvol import SamConfig as JaxSamConfig
from mmmm_tpu.models.segvol import sam as jsam
from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu.ops import dense_attn as jdense
from mmmm_tpu.ops import quant as jquant
from mmmm_tpu_torch import MMMMConfig, generate_grounded, params_from_jax
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.models.segvol import sam as psam
from mmmm_tpu_torch.ops import decode_kernel as pdec
from mmmm_tpu_torch.ops import dense_attn as pdense
from test_torch_port_decode import _t
from test_torch_port_models import numpy_params
from test_torch_port_slice import N_VIS, PATCH, POOL, _ground_head, _prompts
from test_torch_port_w4 import w4_config

FP32 = dict(atol=1e-5, rtol=0)
BF16_STEP = dict(atol=2 ** -7, rtol=2 ** -8)
MAX_NEW = 8


# ---- K10: split-int8 decode read ------------------------------------------------------

def test_q14_split_bit_equal():
    x = (np.random.default_rng(2).normal(size=(3, 5, 1, 32)) * 7.0).astype(np.float32)
    x[0, 0, 0, :4] = 0.0
    got = pdec.q14_split(torch.from_numpy(x), (-1, -2))
    want = jdec._q14_split(jnp.asarray(x), amax_axes=(-1, -2))
    for g, w in zip(got, want):
        assert g.dtype == _t(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _q8_cache(rng, b, h, smax, d):
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.float32))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.float32))
    return kq, ks, vq, vs


@pytest.mark.parametrize("d,lens,bf16", [(16, [40, 64, 0], False), (64, [1, 33, 64], True),
                                         (48, [7, 64, 0], False), (80, [64, 2, 31], True),
                                         (100, [50, 0, 64], False)])
def test_decode_attention_q8_mxu_plain_matches_pallas(d, lens, bf16):
    """fp32 queries within 1e-5; bf16 queries give bf16 outputs within one
    bf16 step. Head dims 48, 80 and 100 are not a whole number of K10's
    16-byte lanes: the reference takes any D as one block."""
    rng = np.random.default_rng(d)
    b, h, smax = 3, 8, 64
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    if bf16:
        q = q.astype(ml_dtypes.bfloat16)
    leaves = _q8_cache(rng, b, h, smax, d)
    kv_len = np.asarray(lens, np.int32)
    want = np.asarray(jdec.decode_attention_pallas_q8_mxu(jnp.asarray(q), *leaves,
                                                          jnp.asarray(kv_len)))
    got = pdec.decode_attention_q8_mxu_plain(_t(q), *map(_t, leaves), torch.from_numpy(kv_len))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **(BF16_STEP if bf16 else FP32))
    if 0 in lens:
        assert np.all(got.numpy()[lens.index(0)] == 0)


def test_decode_attention_q8_mxu_int32_wrap_band():
    """kv_len 1100 > 1040 under uniform attention (q = 0) over rows of 127:
    |o32| = 128 * 127 * 127 * 1100 passes 2**31, and the port wraps as the
    reference's int32 does, bit for bit."""
    b, h, smax, d = 1, 1, 1100, 16
    kq = np.full((b, h, smax, d), 127, np.int8)
    ks = np.ones((b, h, smax, 1), ml_dtypes.bfloat16)
    q = np.zeros((b, 1, h, d), np.float32)
    kv_len = np.asarray([smax], np.int32)
    leaves = (kq, ks, kq, ks)
    want = np.asarray(jdec.decode_attention_pallas_q8_mxu(
        jnp.asarray(q), *map(jnp.asarray, leaves), jnp.asarray(kv_len)))
    got = pdec.decode_attention_q8_mxu_plain(torch.from_numpy(q), *map(_t, leaves),
                                             torch.from_numpy(kv_len))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want < 0)  # the dequantized answer is +127; the int32 sum wrapped


def test_decode_attention_q8_routes_as_the_reference():
    """``q8_mxu=True`` takes K10 while ``8 * chunk * Smax * D <= 12 MiB``
    (Smax <= 1536 at H=32, D=128) and K9 above it; without it, K9."""
    rng = np.random.default_rng(9)
    for smax, mxu in ((320, True), (1537, False)):
        q = torch.from_numpy(rng.normal(size=(1, 1, 32, 128)).astype(np.float32))
        leaves = tuple(map(_t, _q8_cache(rng, 1, 32, smax, 128)))
        kv_len = torch.tensor([smax - 7], dtype=torch.int32)
        got = pdec.decode_attention_q8(q, *leaves, kv_len, q8_mxu=True)
        plain = pdec.decode_attention_q8_mxu_plain if mxu else pdec.decode_attention_q8_plain
        torch.testing.assert_close(got, plain(q, *leaves, kv_len), rtol=0, atol=0)
        torch.testing.assert_close(pdec.decode_attention_q8(q, *leaves, kv_len),
                                   pdec.decode_attention_q8_plain(q, *leaves, kv_len),
                                   rtol=0, atol=0)


# ---- K12 (the K4 kernel on (B, S, H, D)) and P1 --------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_dense_attention_matches_bshd_kernel(bf16):
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 40, 8, 16)).astype(np.float32) for _ in range(3))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = np.asarray(jdense._dense_fwd_bshd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                             0.25)).astype(np.float32)
    got = pdense.dense_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), 0.25)
    np.testing.assert_allclose(got.float().numpy(), want, **(BF16_STEP if bf16 else FP32))


def _nosm_numpy(q, k, v, scale, out_dtype):
    """``_kernel_nosm`` (scripts/tpu_probes.py) per (b, h) in numpy: masked
    logits times 1e-4, cast to the value dtype, then P V in fp32."""
    st = scale * np.einsum("bqhd,bkhd->bhqk", q.astype(np.float32), k.astype(np.float32))
    p = (st * np.float32(1e-4)).astype(out_dtype).astype(np.float32)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float32)).astype(out_dtype)


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_attention_nosm_plain_matches_probe(bf16):
    rng = np.random.default_rng(13)
    dt = ml_dtypes.bfloat16 if bf16 else np.float32
    q, k, v = (rng.normal(size=(2, 37, 4, 112)).astype(dt) for _ in range(3))
    want = _nosm_numpy(q, k, v, 112 ** -0.5, dt).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16 if bf16
                                                             else torch.float32)
                  for a in (q, k, v))
    got = pdense.dense_attention_nosm(tq, tk, tv, 112 ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(BF16_STEP if bf16 else dict(atol=1e-6, rtol=0)))


# ---- instance SAM -----------------------------------------------------------------------

def test_instance_sam_forward_matches_jax():
    cfg = MMMMConfig.tiny()
    tree = numpy_params(cfg, 5)
    params = params_from_jax(tree, "cpu", cfg=cfg)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 3, 4, 16, 16)).astype(np.float32)
    prompts = rng.normal(size=(2, 3, cfg.sam.embed_dim)).astype(np.float32)
    names = ("boxes", "disc_logit", "masks_logits", "masks_logits_low_res")
    fwd = jax.jit(lambda p, i, t: tuple(getattr(jsam.instance_sam_forward(
        p, JaxConfig.tiny().sam, i, PATCH, t, attn_impl="xla"), n) for n in names))
    want = fwd(jax.tree.map(jnp.asarray, tree["isam"]), jnp.asarray(img), jnp.asarray(prompts))
    with torch.inference_mode():
        got = psam.instance_sam_forward(params["isam"], cfg.sam, torch.from_numpy(img), PATCH,
                                        torch.from_numpy(prompts))
    k1 = cfg.sam.num_mask_tokens
    assert got.boxes.shape == (2, 3, k1, 6) and got.disc_logit.shape == (2, 3, k1 - 1)
    for name, w in zip(names, want):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w), err_msg=name,
                                   **FP32)


# ---- generate_grounded --------------------------------------------------------------

@pytest.fixture
def jax_env(monkeypatch):
    """Set the reference's switches for one run, with fresh stage caches."""
    def setenv(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jinf._generate_stage.cache_clear()
        jinf._grounding_stage.cache_clear()
    yield setenv
    jinf._generate_stage.cache_clear()
    jinf._grounding_stage.cache_clear()


def _fixture_tree(cfg, tok, bits=0, bias=1):
    """The slice fixture's tree (``_ground_head`` applied ``bias`` times),
    its LLM quantized by the JAX package when ``bits`` is given: (JAX tree,
    port params)."""
    tree = numpy_params(cfg, 2)
    for _ in range(bias):
        _ground_head(tree, tok)
    jtree = jax.tree.map(jnp.asarray, tree)
    if bits:
        jtree["cogvlm"] = jquant.quantize_llm_for_serving(jtree["cogvlm"],
                                                          release_originals=False, bits=bits)
    return jtree, params_from_jax(jax.tree.map(np.asarray, jtree), "cpu", cfg=cfg)


def _compare(cfg, jcfg, jtree, params, *, attn_impl="xla", port_kw=None,
             targets=(["z", "z"], ["z", "z"], []), num_generated=(8, 8, 1), mask_tol=None,
             **kw):
    tok, jtok = MMMMTokenizer.byte_fallback(), JaxTokenizer.byte_fallback()
    ids, tt, pos, lens, img, gimg = _prompts()
    kw = dict(max_new_tokens=MAX_NEW, max_targets=2, force_grounding=True,
              vis_span=(1, 1 + N_VIS), **kw)
    ref = jinf.generate_grounded(jtree, jcfg, jtok, *(jnp.asarray(x) for x in (ids, tt, pos,
                                                                               lens, img)),
                                 PATCH, POOL, grounding_image=jnp.asarray(gimg),
                                 attn_impl=attn_impl, **kw)
    got = generate_grounded(params, cfg, tok, ids, tt, pos, lens, img, PATCH, POOL,
                            grounding_image=gimg, device="cpu", **kw, **(port_kw or {}))
    np.testing.assert_array_equal(got.tokens, np.asarray(ref.tokens))
    assert got.text == ref.text and got.targets == ref.targets
    # the fixture writes grounded spans and ends one sample early
    assert got.targets == list(targets)
    assert got.num_generated.tolist() == list(num_generated)
    np.testing.assert_array_equal(got.target_valid, ref.target_valid)
    if kw.get("spec_draft_len"):
        assert got.spec_stats["iters"] == int(ref.spec_stats["iters"])
    if kw.get("instance"):
        assert got.masks is None and got.boxes.dtype == torch.float32
        assert got.boxes.shape == (3, 2, cfg.sam.num_mask_tokens - 1, 6)
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.disc_logit.numpy(), np.asarray(ref.disc_logit),
                                   atol=1e-4, rtol=0)
    else:
        want = np.asarray(ref.masks).astype(np.float32)
        atol = 2e-4 if mask_tol is None else mask_tol * np.abs(want).max()
        np.testing.assert_allclose(got.masks.float().numpy(), want, atol=atol, rtol=0)
    return got


@pytest.fixture(scope="module")
def tiny_trees():
    tok = MMMMTokenizer.byte_fallback()
    cfg = MMMMConfig.tiny(vocab_size=len(tok))
    return cfg, JaxConfig.tiny(vocab_size=len(tok)), tok


def test_generate_grounded_instance_matches_jax(tiny_trees, jax_env):
    cfg, jcfg, tok = tiny_trees
    jax_env()
    _compare(cfg, jcfg, *_fixture_tree(cfg, tok), instance=True)


@pytest.mark.parametrize("mode,spec", [("all", 0), ("vit", 0), ("all", 3), ("vit", 3)])
def test_generate_grounded_prefill_chunk_matches_jax(tiny_trees, jax_env, mode, spec):
    """Three samples in chunks of 2: mode "all" pads a fourth row
    (prompt_len 1) and decodes greedy at the padded batch."""
    cfg, jcfg, tok = tiny_trees
    jax_env(MMMM_PREFILL_CHUNK_MODE=mode)
    _compare(cfg, jcfg, *_fixture_tree(cfg, tok, bits=8), prefill_chunk=2,
             spec_draft_len=spec, port_kw=dict(chunk_mode=mode))


@pytest.mark.parametrize("switch", ["w8a8", "w8a8_prefill"])
def test_generate_grounded_w8a8_matches_jax(tiny_trees, jax_env, switch):
    cfg, jcfg, tok = tiny_trees
    jax_env(**{f"MMMM_{switch.upper()}": "1"})
    _compare(cfg, jcfg, *_fixture_tree(cfg, tok, bits=8), kv_cache_dtype="int8",
             port_kw={switch: True})


def test_generate_grounded_w4_split_int8_matches_jax(jax_env):
    """W4A16 weights, the int8 KV cache read by the split-int8 kernel,
    instance SAM and chunked prefill together, at the W4-capable widths;
    the reference runs its Pallas kernels (interpret mode) so that its
    decode takes ``decode_attention_pallas_q8_mxu``."""
    tok = MMMMTokenizer.byte_fallback()
    cfg = w4_config(len(tok))
    v, s = cfg.vlm, cfg.sam
    jcfg = JaxConfig(
        vlm=JaxCogVLMConfig(vocab_size=v.vocab_size, hidden_size=v.hidden_size,
                            intermediate_size=v.intermediate_size,
                            num_hidden_layers=v.num_hidden_layers,
                            num_attention_heads=v.num_attention_heads,
                            max_position_embeddings=v.max_position_embeddings,
                            vision=JaxVisionConfig.tiny()),
        sam=JaxSamConfig.tiny())
    assert jcfg.sam == JaxSamConfig(**{f: getattr(s, f) for f in s.__dataclass_fields__})
    jax_env(MMMM_Q8_MXU="1")
    # at these widths the doubled bias gives one span, and eos in the second sample
    jtree, params = _fixture_tree(cfg, tok, bits=4, bias=2)
    assert "q4" in params["cogvlm"]["llm"]["layers"]["lang_qkv"]
    _compare(cfg, jcfg, jtree, params, attn_impl="pallas", kv_cache_dtype="int8", instance=True,
             prefill_chunk=2, port_kw=dict(q8_mxu=True), targets=([], None, ["z"]),
             num_generated=(8, 2, 8))


def test_generate_grounded_sam_bf16_matches_jax(tiny_trees, jax_env):
    """``sam_bf16`` runs the SAM head and its prompts in bf16 (``vg_proj``
    stays fp32), as ``MMMM_SAM_BF16=1`` does. The two frameworks round to
    bf16 at other places through the two-way transformer and the
    upsampling: masks agree within 2**-4 of the largest mask logit (about
    eight bf16 steps there)."""
    cfg, jcfg, tok = tiny_trees
    jax_env(MMMM_SAM_BF16="1")
    got = _compare(cfg, jcfg, *_fixture_tree(cfg, tok), port_kw=dict(sam_bf16=True),
                   mask_tol=2 ** -4)
    assert got.masks.dtype == torch.bfloat16
