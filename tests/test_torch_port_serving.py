"""The port's continuous-batching servers (``models/serving.py``) and
``make_text_generator`` (``models/llm_batch.py``) against the JAX package's.

At ``MMMMConfig.tiny()`` in fp32 on the CPU, one seeded numpy tree in the
JAX layout (with tests/test_torch_port_slice.py's ``<p>`` head bias, so
that texts hold grounded spans and n-gram drafts are accepted) is bridged
with ``params_from_jax``; each test mirrors one of tests/test_serving.py or
tests/test_llm_batch.py. Texts equal the JAX servers' (``attn_impl="xla"``),
and so do the servers' ``stats`` where the test says; masks within atol
2e-4 (tests/test_serving.py's tolerance). Each JAX server compiles its
stages once, so the JAX results are shared through module fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.data.tokenizer import MMMMTokenizer as JaxTokenizer
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import inference as jinf
from mmmm_tpu.models import llm_batch as jbatch
from mmmm_tpu.models import serving as jserving
from mmmm_tpu.ops.quant import quantize_llm_for_serving as jax_quantize
from mmmm_tpu_torch import MMMMConfig, generate_grounded, params_from_jax
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.models.llm_batch import make_text_generator
from mmmm_tpu_torch.models.serving import GroundedServer, TextServer
from test_serving import N_VIS, _grounded_reqs
from test_torch_port_models import numpy_params, one_thread  # noqa: F401
from test_torch_port_slice import _ground_head

TEMPLATE = "You are a radiology assistant. Extract findings from: "
PROMPTS = ["a", "the quick brown fox", "mid", "another prompt here",
           "yet another much longer prompt for the pool", "zz", "last one"]
GROUNDED = dict(patch_size=(4, 4, 4), pool_size=(1, 1, 1), n_vis=N_VIS, n_slots=2,
                max_new_tokens=6, chunk=3, seq_quant=16, max_targets=2)


@pytest.fixture(scope="module")
def setup():
    """(port tokenizer, port config, JAX tokenizer, JAX config, JAX tree,
    port params), all at the tiny config in fp32."""
    tok, jtok = MMMMTokenizer.byte_fallback(), JaxTokenizer.byte_fallback()
    cfg, jcfg = MMMMConfig.tiny(vocab_size=len(tok)), JaxConfig.tiny(vocab_size=len(jtok))
    tree = numpy_params(cfg, 0)
    _ground_head(tree, tok)
    return tok, cfg, jtok, jcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu",
                                                                                cfg=cfg)


def _jax_text(setup, prompts, budgets=None, **kw):
    """The JAX TextServer's completions and stats."""
    _, _, jtok, jcfg, jtree, _ = setup
    server = jserving.TextServer(jtree["cogvlm"], jcfg.vlm, jtok, attn_impl="xla", **kw)
    return server.generate(prompts, max_new=budgets), server.stats


def _text(setup, prompts, budgets=None, **kw):
    tok, cfg, _, _, _, params = setup
    server = TextServer(params["cogvlm"], cfg.vlm, tok, device="cpu", **kw)
    return server.generate(prompts, max_new=budgets), server.stats


def test_continuous_batching_matches_static(setup):
    """Two slots, seven prompts: each completion is the JAX server's and the
    port's static ``make_text_generator``'s, whatever slot it took."""
    tok, cfg, _, _, _, params = setup
    kw = dict(n_slots=2, max_new_tokens=6, chunk=3, seq_quant=16, max_prompt_len=64)
    ref, ref_stats = _jax_text(setup, PROMPTS, **kw)
    served, stats = _text(setup, PROMPTS, **kw)
    static = make_text_generator(params["cogvlm"], cfg.vlm, tok, max_new_tokens=6, batch_size=2,
                                 device="cpu")(PROMPTS)
    assert served == static == ref
    assert stats == ref_stats and stats["prefix_len"] == 0


@pytest.mark.parametrize("n_slots,budgets,refills", [(2, [2, 8, 2, 2, 8, 2], 3),
                                                     (4, [2, 8, 2, 2, 8, 2, 2], 2)])
def test_server_refills_mid_flight(setup, n_slots, budgets, refills):
    """Staggered budgets free slots while their neighbours decode: the same
    texts, refills and chunk counts as the JAX server. With 4 slots the
    second refill takes 3 requests, a sub-batch padded to 4 with a row of
    ``prompt_len`` 1."""
    prompts = ["one", "two", "three", "four", "five", "six", "seven"][: len(budgets)]
    kw = dict(n_slots=n_slots, max_new_tokens=8, chunk=2, seq_quant=16, max_prompt_len=64)
    ref, ref_stats = _jax_text(setup, prompts, budgets, **kw)
    outs, stats = _text(setup, prompts, budgets, **kw)
    assert outs == ref
    assert stats == ref_stats
    assert stats["refills"] >= refills and stats["refilled_mid_flight"] >= 1
    assert stats["chunks"] <= 12


def test_prefix_cache_matches_full_prefill(setup):
    """Templated prompts: the shared 55-token prefix prefilled once and each
    suffix (16 or 32 tokens, past K6's 8) run as one decode window give the
    full prefill's texts and the JAX server's, with its stats."""
    prompts = [TEMPLATE + b for b in ["small nodule", "clear lungs", "effusion on the left",
                                       "x", "cardiomegaly with edema and a long tail of text"]]
    kw = dict(n_slots=2, max_new_tokens=6, chunk=3, seq_quant=16, max_prompt_len=128)
    ref, ref_stats = _jax_text(setup, prompts, **kw)
    base, _ = _text(setup, prompts, prefix_cache=False, **kw)
    served, stats = _text(setup, prompts, **kw)
    assert served == base == ref
    assert stats == ref_stats
    assert stats["prefix_len"] >= 32
    assert stats["prefix_tokens_saved"] >= 32 * (len(prompts) - 1)


def test_speculative_server_matches_greedy_server(setup):
    """Speculation inside the slot pool, with the prefix cache and
    per-request budgets: the greedy server's texts and the JAX speculative
    server's, with its ``spec_*`` stats; drafts are accepted."""
    bodies = ["aaa bbb aaa bbb aaa", "repeat repeat repeat", "q", "zz yy zz yy"]
    prompts = ["Findings template shared by every request in this job: " + b for b in bodies]
    budgets = [7, 3, 9, 5]
    kw = dict(n_slots=2, max_new_tokens=9, chunk=3, seq_quant=16, max_prompt_len=128)
    ref, ref_stats = _jax_text(setup, prompts, budgets, speculate=4, **kw)
    base, _ = _text(setup, prompts, budgets, **kw)
    outs, stats = _text(setup, prompts, budgets, speculate=4, **kw)
    assert outs == base == ref
    assert stats == ref_stats
    assert stats["prefix_len"] >= 32 and stats["spec_steps"] > 0
    assert stats["spec_committed"] > stats["spec_steps"]


def test_text_server_with_w8a16_params(setup):
    """W8A16 weights quantized by the JAX package: the port's continuous
    (speculative too) and static generators give the JAX continuous
    generator's texts."""
    tok, cfg, jtok, jcfg, jtree, _ = setup
    jparams = jax_quantize(jtree["cogvlm"], release_originals=False)
    tree = jax.tree.map(np.asarray, dict(jtree, cogvlm=jparams))
    params = params_from_jax(tree, "cpu", cfg=cfg)["cogvlm"]
    prompts = ["alpha", "a longer beta prompt", "gamma!"]
    kw = dict(max_new_tokens=5, batch_size=2, seq_quant=16)
    ref = jbatch.make_text_generator(jparams, jcfg.vlm, jtok, continuous=True, attn_impl="xla",
                                     **kw)(prompts)
    for extra in (dict(), dict(continuous=True), dict(continuous=True, speculate=4)):
        assert make_text_generator(params, cfg.vlm, tok, device="cpu", **kw, **extra)(prompts) \
            == ref, extra


def test_make_text_generator_matches_jax(setup):
    """The static path in buckets of ``batch_size``, shortest first: the JAX
    static generator's texts; the same prompt alone gives the same text."""
    tok, cfg, jtok, jcfg, jtree, params = setup
    prompts = ["short", "a much longer prompt with more text", "mid size one"]
    kw = dict(max_new_tokens=6, batch_size=2, seq_quant=16)
    ref = jbatch.make_text_generator(jtree["cogvlm"], jcfg.vlm, jtok, attn_impl="xla",
                                     **kw)(prompts)
    gen = make_text_generator(params["cogvlm"], cfg.vlm, tok, device="cpu", **kw)
    outs = gen(prompts)
    assert outs == ref
    assert gen([prompts[0]]) == [outs[0]]


@pytest.fixture(scope="module")
def grounded(setup):
    """Five grounded requests, tests/test_serving.py's, and the JAX
    GroundedServer's results over them."""
    _, _, jtok, jcfg, jtree, _ = setup
    reqs = _grounded_reqs(5)
    smax = max(len(r["input_ids"]) for r in reqs)
    server = jserving.GroundedServer(jtree, jcfg, jtok, max_prompt_len=smax, attn_impl="xla",
                                     **GROUNDED)
    return reqs, smax, server.generate(reqs), server.stats


def _grounded(setup, reqs, smax, **kw):
    tok, cfg, _, _, _, params = setup
    server = GroundedServer(params, cfg, tok, max_prompt_len=smax, device="cpu", **GROUNDED,
                            **kw)
    return server.generate(reqs), server.stats


def _masks_close(got, ref):
    """Mask logits within 2e-4 and within 1e-3 of the largest (the random
    model's logits are about 1e-4, so 2e-4 alone would pass any mask)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=min(2e-4, 1e-3 * np.abs(ref).max()))


@pytest.fixture(scope="module")
def batch_path(setup, grounded):
    """The port's one-shot ``generate_grounded`` over the same requests,
    right-padded into one batch."""
    tok, cfg, _, _, _, params = setup
    reqs, smax, _, _ = grounded
    pad = lambda k: np.stack([np.pad(r[k], (0, smax - len(r[k]))) for r in reqs])
    return generate_grounded(
        params, cfg, tok, pad("input_ids"), pad("token_type_ids"), pad("position_ids"),
        np.asarray([len(r["input_ids"]) for r in reqs]), np.stack([r["image"] for r in reqs]),
        GROUNDED["patch_size"], GROUNDED["pool_size"], max_new_tokens=6, max_targets=2,
        grounding_image=np.stack([r["grounding_image"] for r in reqs]), force_grounding=True,
        vis_span=(1, 1 + N_VIS), device="cpu")


def test_grounded_server_matches_jax_and_batch_path(setup, grounded, batch_path):
    """Texts, tokens, targets and stats of the JAX GroundedServer; texts and
    masks of the port's ``generate_grounded``; the JAX server's masks on
    every target but those whose ``</p>`` is a slot's last kept token: the
    JAX server's greedy ring buffer lets the step after it overwrite its
    hidden state (``GroundedServer._decode_chunk``), the port keeps it, as
    ``generate_grounded`` does."""
    reqs, smax, ref, ref_stats = grounded
    out, stats = _grounded(setup, reqs, smax)
    assert [o["text"] for o in out] == [o["text"] for o in ref] == batch_path.text
    assert stats == ref_stats and stats["refills"] >= 2
    last = GROUNDED["max_new_tokens"] - 1
    eop = setup[0].eop_token_id
    held = {"jax": 0, "last": 0}
    for i, (o, r) in enumerate(zip(out, ref)):
        np.testing.assert_array_equal(o["tokens"], r["tokens"])
        assert o["targets"] == r["targets"]
        np.testing.assert_array_equal(o["target_valid"], r["target_valid"])
        _masks_close(o["masks"], batch_path.masks[i])
        eops = np.nonzero(o["tokens"] == eop)[0][: GROUNDED["max_targets"]]
        for n, t in enumerate(eops):
            if t == last:
                held["last"] += 1
            else:
                _masks_close(o["masks"][n], np.asarray(r["masks"])[n])
                held["jax"] += 1
    assert held["jax"] and held["last"]


def test_grounded_server_speculative_matches_greedy(setup, grounded, batch_path):
    """Speculative grounded serving (3 drafts) gives the greedy server's
    texts and, through the k-wide ring-buffer writes, the masks of the
    greedy server and ``generate_grounded``."""
    reqs, smax, ref, _ = grounded
    base, _ = _grounded(setup, reqs, smax)
    out, stats = _grounded(setup, reqs, smax, speculate=3)
    assert [o["text"] for o in out] == [o["text"] for o in ref] == [o["text"] for o in base]
    assert stats["spec_steps"] > 0
    for i, (o, g) in enumerate(zip(out, base)):
        _masks_close(o["masks"], g["masks"])
        _masks_close(o["masks"], batch_path.masks[i])


def test_servers_run_on_the_card_by_default(setup):
    """Without ``device="cpu"`` a server runs on CUDA: with no card it
    raises, and params on the CPU are refused for a CUDA run."""
    tok, cfg, _, _, _, params = setup
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params lie on"):
            TextServer(params["cogvlm"], cfg.vlm, tok)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextServer(params["cogvlm"], cfg.vlm, tok)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GroundedServer(params, cfg, tok, **GROUNDED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_text_generator(params["cogvlm"], cfg.vlm, tok)
