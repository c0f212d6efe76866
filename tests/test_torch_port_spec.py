"""The port's second slice as a whole: n-gram speculative decode, W8A16
weights and the int8 KV cache in ``generate_grounded``.

At ``MMMMConfig.tiny()`` in fp32 on the CPU, with the fixture of
tests/test_torch_port_slice.py and LLM weights quantized by the JAX
package's ``quantize_llm_for_serving`` and bridged, the port's
``generate_grounded`` is held against
``mmmm_tpu.models.inference.generate_grounded(attn_impl="xla")``: tokens,
``num_generated``, texts, targets and ``spec_stats["iters"]`` identical,
masks within atol 2e-4 (tests/test_serving.py's tolerance). The port's
speculative decode is held against its own greedy decode as
tests/test_speculative.py holds the reference's: identical tokens and
``num_generated``, hidden states within rtol 1e-4, atol 1e-5 (the verify
window reduces in another order than the single-token step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.data.tokenizer import MMMMTokenizer as JaxTokenizer
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import inference as jinf
from mmmm_tpu.models.speculate import ngram_draft as jax_ngram_draft
from mmmm_tpu.ops.quant import quantize_llm_for_serving as jax_quantize
from mmmm_tpu_torch import MMMMConfig, generate_grounded, params_from_jax
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.models.generate import greedy_generate
from mmmm_tpu_torch.models.speculate import ngram_draft, ngram_speculative_generate
from test_torch_port_models import numpy_params
from test_torch_port_slice import N_VIS, PATCH, POOL, _ground_head, _prompts

MAX_NEW = 8


@pytest.fixture(scope="module")
def quantized():
    """The slice fixture's tree with the LLM quantized by the JAX package:
    (port config, tokenizer, JAX tree of jnp arrays, port params)."""
    tok = MMMMTokenizer.byte_fallback()
    cfg = MMMMConfig.tiny(vocab_size=len(tok))
    tree = numpy_params(cfg, 2)
    _ground_head(tree, tok)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["cogvlm"] = jax_quantize(jtree["cogvlm"], release_originals=False)
    params = params_from_jax(jax.tree.map(np.asarray, jtree), "cpu", cfg=cfg)
    return cfg, tok, jtree, params


@pytest.mark.parametrize("spec,kv", [(3, "bf16"), (7, "bf16"), (8, "bf16"), (0, "int8"),
                                     (3, "int8")])
def test_generate_grounded_w8a16_matches_jax(quantized, spec, kv):
    cfg, tok, jtree, params = quantized
    jtok = JaxTokenizer.byte_fallback()
    jcfg = JaxConfig.tiny(vocab_size=len(jtok))
    ids, tt, pos, lens, img, gimg = _prompts()
    kw = dict(max_new_tokens=MAX_NEW, max_targets=2, force_grounding=True,
              vis_span=(1, 1 + N_VIS), kv_cache_dtype=kv, spec_draft_len=spec)
    jargs = tuple(jnp.asarray(x) for x in (ids, tt, pos, lens, img))
    ref = jinf.generate_grounded(jtree, jcfg, jtok, *jargs, PATCH, POOL,
                                 grounding_image=jnp.asarray(gimg), attn_impl="xla", **kw)
    # the jitted stage generate_grounded just ran (lru-cached): its num_generated
    stage = jinf._generate_stage(jcfg, MAX_NEW, jtok.eos_token_id, jtok.bop_token_id,
                                 jtok.eop_token_id, PATCH, POOL, "xla", True, (1, 1 + N_VIS),
                                 kv, spec, 0, False, 1, True, "all")
    ref_gen, _ = stage(jtree, *jargs)

    got = generate_grounded(params, cfg, tok, ids, tt, pos, lens, img, PATCH, POOL,
                            grounding_image=gimg, device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated, np.asarray(ref_gen.num_generated))
    assert got.text == ref.text
    assert got.targets == ref.targets
    # the fixture writes grounded spans and ends one sample early
    assert got.targets[:2] == [["z", "z"], ["z", "z"]]
    assert got.num_generated.tolist() == [8, 8, 1]
    if spec:
        assert got.spec_stats["iters"] == int(ref.spec_stats["iters"])
        np.testing.assert_allclose(got.spec_stats["tokens_per_step"],
                                   float(ref.spec_stats["tokens_per_step"]), rtol=1e-6)
    else:
        assert got.spec_stats is None and ref.spec_stats is None
    np.testing.assert_array_equal(got.target_valid, ref.target_valid)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(ref.masks), atol=2e-4, rtol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_speculative_matches_greedy(quantized, kv):
    """The port's speculation against its own greedy decode over W8A16
    weights, with the ``<p>`` freeze inside verify windows and a row that
    stops at eos."""
    cfg, tok, _, params = quantized
    ids, tt, pos, lens, img, _ = _prompts()
    args = (params["cogvlm"], cfg.vlm, *(torch.from_numpy(x) for x in (ids, tt, pos, lens)))
    kw = dict(max_new_tokens=12, eos_token_id=tok.eos_token_id, bop_token_id=tok.bop_token_id,
              eop_token_id=tok.eop_token_id, image=torch.from_numpy(img), patch_size=PATCH,
              pool_size=POOL, vis_span=(1, 1 + N_VIS), kv_cache_dtype=kv)
    with torch.inference_mode():
        res_g = greedy_generate(*args, **kw)
        for draft_len in (3, 7, 8):
            res_s, stats = ngram_speculative_generate(*args, draft_len=draft_len,
                                                      return_stats=True, **kw)
            assert torch.equal(res_s.tokens, res_g.tokens)
            assert torch.equal(res_s.num_generated, res_g.num_generated)
            assert res_g.num_generated.tolist() == [12, 12, 1]
            for i, n in enumerate(res_g.num_generated.tolist()):
                torch.testing.assert_close(res_s.hidden[i, :n], res_g.hidden[i, :n],
                                           rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(res_s.prefill_hidden, res_g.prefill_hidden,
                                       rtol=0, atol=0)
            # the fixture's output repeats "a<p>z</p>", so drafts are accepted
            assert stats["iters"] < 12 and stats["tokens_per_step"] > 1.0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_speculative_draft8_matches_jax(quantized, kv):
    """``ngram_speculative_generate`` with 8 drafts (verify windows of 9,
    past K6's 8: the decoder's plain route on a bf16 cache) against the
    reference's: tokens, ``num_generated`` and verify steps equal; on the
    bf16-path cache (fp32 here) the hidden states within 1e-4 (on the int8
    cache a slot's quantization may round the other way)."""
    from mmmm_tpu.models.speculate import ngram_speculative_generate as jax_spec

    cfg, tok, jtree, params = quantized
    jtok = JaxTokenizer.byte_fallback()
    jcfg = JaxConfig.tiny(vocab_size=len(jtok))
    ids, tt, pos, lens, img, _ = _prompts()
    kw = dict(max_new_tokens=12, eos_token_id=tok.eos_token_id, bop_token_id=tok.bop_token_id,
              eop_token_id=tok.eop_token_id, patch_size=PATCH, pool_size=POOL,
              vis_span=(1, 1 + N_VIS), kv_cache_dtype=kv, draft_len=8, return_stats=True)
    ref, ref_stats = jax_spec(jtree["cogvlm"], jcfg.vlm,
                              *(jnp.asarray(x) for x in (ids, tt, pos, lens)),
                              image=jnp.asarray(img), attn_impl="xla", **kw)
    with torch.inference_mode():
        got, stats = ngram_speculative_generate(
            params["cogvlm"], cfg.vlm, *(torch.from_numpy(x) for x in (ids, tt, pos, lens)),
            image=torch.from_numpy(img), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), np.asarray(ref.num_generated))
    assert stats["iters"] == int(ref_stats["iters"]) < 12
    for i, n in enumerate(got.num_generated.tolist() if kv == "bf16" else []):
        np.testing.assert_allclose(got.hidden[i, :n].numpy(), np.asarray(ref.hidden)[i, :n],
                                   atol=1e-4, rtol=0)


def _jax_draft(hist, hist_len, n_draft, ngram):
    return np.asarray(jax_ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len),
                                      n_draft=n_draft, ngram=ngram))


@pytest.mark.parametrize("vocab", [3, 50])
def test_ngram_draft_matches_jax(vocab):
    """Random histories: a vocabulary of 3 makes the trailing n-gram recur
    (matches, continuations cut by the valid region), 50 mostly not."""
    rng = np.random.default_rng(vocab)
    b, length = 16, 24
    hist = rng.integers(0, vocab, size=(b, length)).astype(np.int32)
    hist_len = rng.integers(1, length + 1, size=b).astype(np.int32)
    hist_len[:2] = (1, length)
    for ngram in (1, 2, 3):
        for n_draft in (1, 3, 7):
            got = ngram_draft(torch.from_numpy(hist), torch.from_numpy(hist_len),
                              n_draft=n_draft, ngram=ngram)
            np.testing.assert_array_equal(got.numpy(), _jax_draft(hist, hist_len, n_draft, ngram))


def test_ngram_draft_cases():
    """The hand-made histories of tests/test_speculative.py."""
    cases = [([[7, 8, 4, 9, 5, 6, 1, 3, 4, 9, 0, 0]], [10], 3, [[5, 6, 1]]),
             ([[4, 9, 2, 2, 2, 4, 9, 8, 8, 4, 9, 0]], [11], 2, [[8, 8]]),
             ([[1, 2, 3, 4, 5, 0, 0, 0]], [5], 3, [[5, 5, 5]]),
             ([[3, 4, 6, 3, 4, 0, 0, 0]], [5], 3, [[6, 3, 4]])]
    for hist, hist_len, n_draft, want in cases:
        hist, hist_len = np.asarray(hist, np.int32), np.asarray(hist_len, np.int32)
        got = ngram_draft(torch.from_numpy(hist), torch.from_numpy(hist_len), n_draft=n_draft)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), _jax_draft(hist, hist_len, n_draft, 2))


def test_speculative_refuses_what_is_not_ported(quantized):
    cfg, tok, _, params = quantized
    ids, tt, pos, lens, _, _ = _prompts()
    args = (params["cogvlm"], cfg.vlm, *(torch.from_numpy(x) for x in (ids, tt, pos, lens)))
    kw = dict(max_new_tokens=2, eos_token_id=tok.eos_token_id, bop_token_id=tok.bop_token_id,
              eop_token_id=tok.eop_token_id)
    with pytest.raises(ValueError, match="chunk_mode"):
        ngram_speculative_generate(*args, prefill_chunk=2, chunk_mode="llm", **kw)
    with pytest.raises(ValueError, match="draft_len"):
        ngram_speculative_generate(*args, draft_len=0, **kw)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        greedy_generate(*args, kv_cache_dtype="fp8", **kw)
