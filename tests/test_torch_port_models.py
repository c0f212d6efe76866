"""The port's model functions against the JAX package at ``MMMMConfig.tiny()``
in fp32 on the CPU: the same parameters (a seeded numpy tree in the JAX
layout, bridged with ``params_from_jax``) and the same seeded numpy inputs,
atol 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models.cogvlm import decoder as jdecoder
from mmmm_tpu.models.cogvlm import vit as jvit
from mmmm_tpu.models.segvol import sam as jsam
from mmmm_tpu_torch import MMMMConfig, params_from_jax
from mmmm_tpu_torch.params import param_spec
from mmmm_tpu_torch.models.cogvlm import decoder as pdecoder
from mmmm_tpu_torch.models.cogvlm import vit as pvit
from mmmm_tpu_torch.models.segvol import sam as psam

TOL = dict(atol=1e-4, rtol=0)
PATCH = (4, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a module's tiny tensors (the modules that
    import this fixture): the suite runs six workers on the host's cores,
    where each worker's default thread pool oversubscribes them
    (tests/test_torch_port_remat.py measured a port step about ten times
    slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(cfg, seed):
    """A random fp32 tree in the JAX layout, initialized as the JAX init
    does (normal * std, zeros, ones); test_torch_port_slice.py holds the
    layout against ``MMMMModel(cfg).init``."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if node.init == "normal":
            return (rng.normal(size=node.shape) * node.std).astype(np.float32)
        return (np.zeros if node.init == "zeros" else np.ones)(node.shape, np.float32)

    return fill(param_spec(cfg))


@pytest.fixture(scope="module")
def setup():
    cfg = MMMMConfig.tiny()
    tree = numpy_params(cfg, 0)
    pparams = params_from_jax(tree, "cpu", cfg=cfg)
    return JaxConfig.tiny(), jax.tree.map(jnp.asarray, tree), cfg, pparams


def _prompt(rng, b, s, n_vis, c):
    emb = rng.normal(size=(b, s, c)).astype(np.float32) * 0.02
    tt = np.zeros((b, s), np.int32)
    tt[:, 1:1 + n_vis] = 1
    pos = np.tile(np.concatenate([[0, 1], np.full(n_vis - 2, 2), [3],
                                  np.arange(4, 4 + s - n_vis - 1)]), (b, 1)).astype(np.int32)
    lens = np.array([s, s - 3])
    seg = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    return emb, tt, pos, seg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("pool", [(1, 1, 1), (1, 2, 2)])
def test_vit_forward(setup, pool):
    jcfg, jparams, cfg, pparams = setup
    img = np.random.default_rng(0).normal(size=(2, 3, 8, 16, 16)).astype(np.float32)
    ref = jvit.vit_forward(jparams["cogvlm"]["vision"], jcfg.vlm, jnp.asarray(img), PATCH, pool,
                           attn_impl="xla")
    got = pvit.vit_forward(pparams["cogvlm"]["vision"], cfg.vlm, _t(img), PATCH, pool)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("vis_span", [(1, 7), None])
def test_llm_prefill_and_decode_step(setup, vis_span):
    """Prefill hidden states and caches (static span and dual masked
    routing), then one decode step's hidden state and appended caches."""
    jcfg, jparams, cfg, pparams = setup
    rng = np.random.default_rng(1)
    b, s, smax = 2, 12, 16
    emb, tt, pos, seg = _prompt(rng, b, s, 6, cfg.vlm.hidden_size)
    jllm, pllm = jparams["cogvlm"]["llm"], pparams["cogvlm"]["llm"]
    jh, jcaches = jdecoder.llm_prefill(jllm, jcfg.vlm, jnp.asarray(emb), jnp.asarray(tt),
                                       jnp.asarray(pos), jnp.asarray(seg), smax=smax,
                                       attn_impl="xla", vis_span=vis_span)
    ph, pcaches = pdecoder.llm_prefill(pllm, cfg.vlm, _t(emb), _t(tt), _t(pos), _t(seg),
                                       smax=smax, vis_span=vis_span)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    for (jk, jv), (pk, pv) in zip(jcaches, pcaches):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)

    x = rng.normal(size=(b, 1, cfg.vlm.hidden_size)).astype(np.float32) * 0.02
    step_pos = np.array([[s - 6], [s - 9]], np.int32)
    write = np.array([s, s - 3], np.int32)
    jh1, jcaches1 = jdecoder.llm_decode_step(jllm, jcfg.vlm, jnp.asarray(x), None,
                                             jnp.asarray(step_pos), jcaches, jnp.asarray(write),
                                             jnp.asarray(write + 1), attn_impl="xla")
    ph1, pcaches1 = pdecoder.llm_decode_step(pllm, cfg.vlm, _t(x), _t(step_pos), pcaches,
                                             _t(write), _t(write + 1))
    np.testing.assert_allclose(ph1.numpy(), np.asarray(jh1), **TOL)
    for (jk, jv), (pk, pv) in zip(jcaches1, pcaches1):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)


def _cache_leaves(cache):
    return list(cache.values()) if isinstance(cache, dict) else list(cache)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("sq", [8, 9, 16])
def test_decode_window_with_clamped_kv_len(setup, kv, sq):
    """A prompt suffix as one decode window, as the servers' prefix refill
    runs it: write index p and ``kv_len[b, j] = p + min(j, suffix_len[b] - 1)
    + 1``, the second row's last 3 positions padding. The valid positions'
    hidden states and the cache slots below ``p + suffix_len`` equal the
    reference's. Windows of more than 8 tokens read ``kv_len`` on either
    cache (every position equal); a pair-cache window of at most 8 is K6's,
    which assumes ``kv_len[b, j] = p + j + 1``."""
    jcfg, jparams, cfg, pparams = setup
    rng = np.random.default_rng(3)
    b, p, smax = 2, 10, 32
    c = cfg.vlm.hidden_size
    emb, tt, pos, _ = _prompt(rng, b, p, 6, c)
    seg = np.ones((b, p), np.int32)
    jllm, pllm = jparams["cogvlm"]["llm"], pparams["cogvlm"]["llm"]
    _, jcaches = jdecoder.llm_prefill(jllm, jcfg.vlm, jnp.asarray(emb), jnp.asarray(tt),
                                      jnp.asarray(pos), jnp.asarray(seg), smax=smax,
                                      attn_impl="xla", kv_cache_dtype=kv)
    _, pcaches = pdecoder.llm_prefill(pllm, cfg.vlm, _t(emb), _t(tt), _t(pos), _t(seg),
                                      smax=smax, kv_cache_dtype=kv)
    x = rng.normal(size=(b, sq, c)).astype(np.float32) * 0.02
    wpos = (p + np.arange(sq, dtype=np.int32))[None].repeat(b, 0)
    write = np.full((b,), p, np.int32)
    sfx = np.array([sq, sq - 3], np.int32)
    kv_len = (p + np.minimum(np.arange(sq)[None], sfx[:, None] - 1) + 1).astype(np.int32)
    jh, jcaches = jdecoder.llm_decode_step(jllm, jcfg.vlm, jnp.asarray(x), None,
                                           jnp.asarray(wpos), jcaches, jnp.asarray(write),
                                           jnp.asarray(kv_len), attn_impl="xla")
    ph, pcaches = pdecoder.llm_decode_step(pllm, cfg.vlm, _t(x), _t(wpos), pcaches, _t(write),
                                           _t(kv_len))
    jh = np.asarray(jh)
    for row, n in enumerate(sfx):
        np.testing.assert_allclose(ph[row, :n].numpy(), jh[row, :n], **TOL)
        for jl, pl in zip(jcaches, pcaches):
            for jt, pt in zip(_cache_leaves(jl), _cache_leaves(pl)):
                np.testing.assert_allclose(pt[row, :, : p + n].float().numpy(),
                                           np.asarray(jt, np.float32)[row, :, : p + n], **TOL)
    if sq > 8 or kv == "int8":
        np.testing.assert_allclose(ph.numpy(), jh, **TOL)


def test_vision_expert_mask():
    tt = np.array([[0, 1, 1, 1, 0, 0], [1, 1, 0, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(pdecoder.vision_expert_mask(_t(tt)).numpy(),
                                  np.asarray(jdecoder.vision_expert_mask(jnp.asarray(tt))))


def test_sam_forward(setup):
    jcfg, jparams, cfg, pparams = setup
    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 3, 4, 16, 16)).astype(np.float32)
    prompts = rng.normal(size=(2, 3, cfg.sam.embed_dim)).astype(np.float32)
    sam = jax.jit(functools.partial(jsam.sam_forward, cfg=jcfg.sam, patch_size=PATCH,
                                    attn_impl="xla"))
    jfull, jlow = sam(jparams["sam"], image=jnp.asarray(img), prompts=jnp.asarray(prompts))
    pfull, plow = psam.sam_forward(pparams["sam"], cfg.sam, _t(img), PATCH, _t(prompts))
    assert pfull.shape == (2, 3, 4, 16, 16)
    np.testing.assert_allclose(plow.numpy(), np.asarray(jlow), **TOL)
    np.testing.assert_allclose(pfull.numpy(), np.asarray(jfull), **TOL)
