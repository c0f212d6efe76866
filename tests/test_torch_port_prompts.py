"""The port's SAM prompt encoders (point, box, mask, ``encode_prompts``) and
``sam_forward_prompted`` against the JAX package's, in fp32 within 1e-5, on
the cases of ``tests/test_prompt_encoder.py`` at ``SamConfig.tiny()`` and at
that file's wider config; and ``pad_attention_heads`` against the JAX
package's, with the padded ViT against the unpadded one on the CPU. One
parameter tree (the port's seeded init) feeds both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.models.cogvlm.vit import pad_attention_heads as jax_pad_heads
from mmmm_tpu.models.segvol import SamConfig as JaxSamConfig
from mmmm_tpu.models.segvol import decoder as jdec
from mmmm_tpu.models.segvol import sam_forward_prompted as jax_prompted
from mmmm_tpu_torch.models.cogvlm.vit import pad_attention_heads, vit_forward
from mmmm_tpu_torch.models.mmmm import MMMMConfig
from mmmm_tpu_torch.models.segvol import SamConfig, decoder as pdec, sam_forward_prompted
from mmmm_tpu_torch.params import _flatten, init_params, init_sam_params

TOL = 1e-5
WIDE = dict(in_channels=1, embed_dim=64, encoder_num_layers=2, encoder_num_heads=2,
            encoder_mlp_ratio=2, patch_size=(4, 16, 16), pos_embed_shape=(4, 8, 8),
            num_instances=2, decoder_depth=2, decoder_num_heads=2, decoder_mlp_dim=64)
# (config kwargs, image (C, D, H, W))
CONFIGS = {"tiny": ({}, (3, 8, 16, 16)), "wide": (WIDE, (1, 16, 64, 64))}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _sam(name):
    """(port config, JAX config, port params, the same as numpy, image shape)."""
    kw, shape = CONFIGS[name]
    cfg = SamConfig(**kw) if kw else SamConfig.tiny()
    jcfg = JaxSamConfig(**kw) if kw else JaxSamConfig.tiny()
    params = init_sam_params(cfg, seed=3, device="cpu")
    return cfg, jcfg, params, _np(params), shape


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _size(shape):
    _, d, h, w = shape
    return (h, w, d)  # (H, W, D), as the prompts take it


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_point_prompt_matches_jax(name):
    _, _, p, jp, shape = _sam(name)
    pts = np.asarray([[10.0, 20.0, 3.0], [5.0, 5.0, 1.0]], np.float32)
    labels = np.asarray([1, 0], np.int64)
    for pad in (True, False):
        got = pdec.encode_point_prompt(p["prompt"], torch.from_numpy(pts),
                                       torch.from_numpy(labels), _size(shape), pad=pad)
        want = jdec.encode_point_prompt(jp["prompt"], jnp.asarray(pts),
                                        jnp.asarray(labels.astype(np.int32)), _size(shape),
                                        pad=pad)
        assert got.shape == (3 if pad else 2, p["prompt"]["no_mask_embed"].shape[0])
        _close(got, want)
    # the padding row is exactly not_a_point (its encoding dropped)
    padded = pdec.encode_point_prompt(p["prompt"], torch.from_numpy(pts),
                                      torch.from_numpy(labels), _size(shape))
    assert torch.equal(padded[2], p["prompt"]["not_a_point_embed"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_box_prompt_matches_jax(name):
    _, _, p, jp, shape = _sam(name)
    boxes = np.asarray([[4.0, 8.0, 1.0, 14.0, 12.0, 6.0], [0.0, 0.0, 0.0, 3.0, 3.0, 2.0]],
                       np.float32)
    got = pdec.encode_box_prompt(p["prompt"], torch.from_numpy(boxes), _size(shape))
    assert got.shape == (4, p["prompt"]["no_mask_embed"].shape[0])
    _close(got, jdec.encode_box_prompt(jp["prompt"], jnp.asarray(boxes), _size(shape)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mask_prompt_matches_jax(name):
    _, _, p, jp, shape = _sam(name)
    mask = (np.random.default_rng(0).uniform(size=(1, 8, 32, 32)) > 0.5).astype(np.float32)
    got = pdec.encode_mask_prompt(p["prompt"], torch.from_numpy(mask))
    assert got.shape == (p["prompt"]["no_mask_embed"].shape[0], 2, 8, 8)
    _close(got, jdec.encode_mask_prompt(jp["prompt"], jnp.asarray(mask)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_prompts_order_and_fallback(name):
    cfg, _, p, jp, shape = _sam(name)
    c = cfg.embed_dim
    pts = (np.asarray([[1.0, 2.0, 3.0]], np.float32), np.asarray([1]))
    boxes = np.asarray([[0.0, 0.0, 0.0, 10.0, 10.0, 5.0]], np.float32)
    text = np.linspace(-1, 1, c).astype(np.float32)
    grid = (2, 4, 4)
    sparse, dense = pdec.encode_prompts(
        p["prompt"], grid, _size(shape), points=tuple(map(torch.from_numpy, pts)),
        boxes=torch.from_numpy(boxes), text_embedding=torch.from_numpy(text))
    jsparse, jdense = jdec.encode_prompts(
        jp["prompt"], grid, _size(shape), points=tuple(map(jnp.asarray, pts)),
        boxes=jnp.asarray(boxes), text_embedding=jnp.asarray(text))
    assert sparse.shape == (4, c) and dense.shape == (c, *grid)  # no padding point with a box
    _close(sparse, jsparse)
    _close(dense, jdense)
    with pytest.raises(ValueError):
        pdec.encode_prompts(p["prompt"], grid, _size(shape))


@pytest.mark.parametrize("name,prompts", [("tiny", "points"), ("tiny", "box"),
                                          ("tiny", "mask_point"), ("tiny", "box_text"),
                                          ("wide", "box")])
def test_sam_forward_prompted_matches_jax(name, prompts):
    """Full-resolution and low-res logits within 1e-5 of the JAX function's
    (the wider config with a box, as ``tests/test_prompt_encoder.py``)."""
    cfg, jcfg, p, jp, shape = _sam(name)
    rng = np.random.default_rng(7)
    image = rng.uniform(size=(1, *shape)).astype(np.float32)
    patch = tuple(cfg.patch_size)
    _, d, h, w = shape
    grid = (d // patch[0], h // patch[1], w // patch[2])
    kw = {}
    if prompts in ("points", "mask_point"):
        kw["points"] = (np.asarray([[w / 2, h / 3, d / 2], [1.0, 2.0, 0.0]], np.float32),
                        np.asarray([1, 0]))
    if prompts in ("box", "box_text"):
        kw["boxes"] = np.asarray([[1.0, 2.0, 0.0, w - 3.0, h - 2.0, d - 1.0]], np.float32)
    if prompts == "mask_point":
        kw["mask"] = (rng.uniform(size=(1, *(4 * g for g in grid))) > 0.5).astype(np.float32)
    if prompts == "box_text":
        kw["text_embedding"] = rng.normal(size=(cfg.embed_dim,)).astype(np.float32)
    to_t = lambda v: tuple(map(torch.from_numpy, v)) if isinstance(v, tuple) \
        else torch.from_numpy(v)
    to_j = lambda v: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
    full, low = sam_forward_prompted(p, cfg, torch.from_numpy(image), patch,
                                     **{k: to_t(v) for k, v in kw.items()})
    jfull, jlow = jax.jit(lambda img: jax_prompted(jp, jcfg, img, patch, **{
        k: to_j(v) for k, v in kw.items()}))(jnp.asarray(image))
    assert full.shape == (d, h, w) and torch.isfinite(full).all()
    _close(low, jlow)
    _close(full, jfull)


@pytest.fixture(scope="module")
def vit():
    """The tiny model's ViT (4 heads of 8) in fp32, its config and an image."""
    cfg = MMMMConfig.tiny()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")["cogvlm"]["vision"]
    image = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 8, 16, 16)).astype(np.float32))
    return cfg.vlm, params, image


@pytest.mark.parametrize("target", [16, 128])
def test_pad_attention_heads_matches_jax(vit, target):
    vcfg, params, _ = vit
    got = pad_attention_heads(params, vcfg.vision.num_heads, target)
    want = jax_pad_heads(_np(params), vcfg.vision.num_heads, target)
    g, w = _flatten(got), _flatten(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    assert g["layers/qkv_w"].shape[-1] == 3 * vcfg.vision.num_heads * target
    assert pad_attention_heads(params, vcfg.vision.num_heads, 8) is params  # already 8 wide


@pytest.mark.parametrize("target", [16, 128])
def test_padded_vit_equals_unpadded(vit, target):
    """The padded tower's tokens within 1e-5 of the unpadded tower's (fp32):
    the zero lanes change only the products' rounding."""
    vcfg, params, image = vit
    heads = vcfg.vision.num_heads
    want = vit_forward(params, vcfg, image, (4, 4, 4), (1, 2, 2))
    got = vit_forward(pad_attention_heads(params, heads, target), vcfg, image, (4, 4, 4),
                      (1, 2, 2))
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
