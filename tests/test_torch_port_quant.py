"""The port's W8A16 serving quantization (``ops/quant.py``) and its parameter
bridge for quantized trees, against the JAX package's ``ops/quant.py``.

``quantize_llm_for_serving`` gives bit-equal int8 values and equal fp32
scales; ``qdot`` agrees to atol 1e-5 in fp32 (the scale is applied after the
product in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import quant as jquant
from mmmm_tpu_torch import MMMMConfig, params_from_jax
from mmmm_tpu_torch.ops import quant as pquant
from mmmm_tpu_torch.params import _flatten
from test_torch_port_models import numpy_params


@pytest.fixture(scope="module")
def trees():
    cfg = MMMMConfig.tiny()
    tree = numpy_params(cfg, 4)
    jq = jquant.quantize_llm_for_serving(jax.tree.map(jnp.asarray, tree["cogvlm"]),
                                         release_originals=False)
    return cfg, tree, jq


def test_quantize_llm_for_serving_matches_jax(trees):
    cfg, tree, jq = trees
    cog = params_from_jax(tree, "cpu", cfg=cfg)["cogvlm"]
    before = {k: v.clone() for k, v in _flatten(cog).items()}
    got = pquant.quantize_llm_for_serving(cog, release_originals=False)
    # release_originals=False leaves the input tree as it was
    assert _flatten(cog).keys() == before.keys()
    assert all(torch.equal(_flatten(cog)[k], v) for k, v in before.items())
    gflat, jflat = _flatten(got), _flatten(jax.tree.map(np.asarray, jq))
    assert gflat.keys() == jflat.keys()
    n_q = 0
    for k, want in jflat.items():
        have = gflat[k].numpy()
        assert have.dtype == want.dtype and have.shape == want.shape, k
        np.testing.assert_array_equal(have, want, err_msg=k)
        n_q += k.endswith("/q")
    assert n_q == 11  # 4 attention experts, 2 x 3 MLP weights, the lm_head


def test_quantize_releases_originals(trees):
    cfg, tree, _ = trees
    cog = params_from_jax(tree, "cpu", cfg=cfg)["cogvlm"]
    layers = cog["llm"]["layers"]
    got = pquant.quantize_llm_for_serving(cog, release_originals=True)
    # the originals are popped from the input tree as they are converted
    assert "lang_qkv" not in layers and "gate" not in layers["lang_mlp"]
    assert "lm_head" not in cog["llm"]
    assert pquant.is_quantized(got["llm"]["lm_head"])
    assert pquant.is_quantized(got["llm"]["layers"]["vis_mlp"]["down"])


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_qdot_matches_jax(trees, lead):
    _, tree, jq = trees
    rng = np.random.default_rng(len(lead))
    for w in (jq["llm"]["lm_head"], jax.tree.map(lambda a: a[1], jq["llm"]["layers"]["lang_qkv"]),
              jnp.asarray(tree["cogvlm"]["llm"]["lm_head"])):
        wt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), w)
        k = (wt["q"] if isinstance(wt, dict) else wt).shape[0]
        x = rng.normal(size=(*lead, k)).astype(np.float32)
        got = pquant.qdot(torch.from_numpy(x), wt)
        np.testing.assert_allclose(got.numpy(), np.asarray(jquant.qdot(jnp.asarray(x), w)),
                                   atol=1e-5, rtol=0)


def test_not_ported_modes_raise(trees):
    """Every serving mode is ported; what the reference's kernels cannot
    take is refused: other bit widths, int4 shapes off the kernel tiles,
    quantization over another axis."""
    _, tree, _ = trees
    w = pquant.quantize_int8(torch.from_numpy(tree["cogvlm"]["llm"]["lm_head"]))
    with pytest.raises(ValueError, match="bits"):
        pquant.quantize_llm_for_serving({"llm": {}}, bits=3)
    with pytest.raises(ValueError, match="2\\*group"):
        pquant.quantize_int4(torch.zeros(128, 256))
    with pytest.raises(ValueError, match="256 kernel tile"):
        pquant.quantize_int4(torch.zeros(256, 128))
    with pytest.raises(ValueError, match="contraction"):
        pquant.quantize_int8(w["q"], axis=-1)


def test_params_from_jax_consumes_quantized_tree(trees):
    """A tree quantized by the JAX package bridges leaf for leaf; a {q, s}
    pair where the port keeps a plain weight, or a stray leaf, is refused."""
    cfg, tree, jq = trees
    qtree = {**tree, "cogvlm": jax.tree.map(np.asarray, jq)}
    params = params_from_jax(qtree, "cpu", cfg=cfg)
    pflat, qflat = _flatten(params), _flatten(qtree)
    assert pflat.keys() == qflat.keys()
    for k, v in qflat.items():
        assert pflat[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(pflat[k].numpy(), v, err_msg=k)
    assert pflat["cogvlm/llm/lm_head/s"].shape == (1, cfg.vlm.vocab_size)

    bad = jax.tree.map(lambda a: a, qtree)
    norm = bad["cogvlm"]["llm"]["norm"]
    bad["cogvlm"]["llm"]["norm"] = {"q": norm.astype(np.int8), "s": norm[None]}
    with pytest.raises(ValueError, match="not consumed.*llm/norm/q.*left unset.*llm/norm"):
        params_from_jax(bad, "cpu")
    bad = jax.tree.map(lambda a: a, qtree)
    bad["cogvlm"]["llm"]["lm_head"]["x"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="not consumed.*lm_head/x"):
        params_from_jax(bad, "cpu")
    bad = jax.tree.map(lambda a: a, qtree)
    bad["cogvlm"]["llm"]["lm_head"]["s"] = np.zeros((2, cfg.vlm.vocab_size), np.float32)
    with pytest.raises(ValueError, match="lm_head/s has shape"):
        params_from_jax(bad, "cpu", cfg=cfg)
