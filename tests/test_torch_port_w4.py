"""The port's W4A16 weights (K11, ``ops/w4_matmul.py``), its W8A8 product and
its ``bits=4`` serving transform against the JAX package on the CPU.

Packing, unpacking and ``quantize_int4`` are bit-equal, and so is W8A8
``qdot`` (exact int32 sums; the same fp32 scaling in the same order).
``w4_matmul_plain`` is ``w4_matmul_xla``: within atol 1e-5 in fp32 (sums
of 512 products taken in another order) and one bf16 step (2**-7 at |y| < 2)
in bf16. The reference's Pallas kernel, run in interpret mode, rounds the
dequantized weight to bf16 whatever x's dtype, so against it fp32 agrees to
1e-2 (bf16 weight rounding over 512 terms). The CUDA kernels are held
against the plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import quant as jquant
from mmmm_tpu.ops import w4_matmul as jw4
from mmmm_tpu_torch import MMMMConfig, params_from_jax
from mmmm_tpu_torch.models.cogvlm.config import CogVLMConfig, VisionConfig
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.ops import quant as pquant
from mmmm_tpu_torch.ops import w4_matmul as pw4
from mmmm_tpu_torch.params import _flatten
from test_torch_port_models import numpy_params

FP32 = dict(atol=1e-5, rtol=0)
BF16_STEP = dict(atol=2 ** -7, rtol=2 ** -8)


def w4_config(vocab_size: int = 128) -> MMMMConfig:
    """The smallest widths the int4 tiles take (2 * 128 | K, 256 | N), as in
    tests/test_quant.py, with the tiny ViT and SAM."""
    return MMMMConfig(vlm=CogVLMConfig(vocab_size=vocab_size, hidden_size=256,
                                       intermediate_size=512, num_hidden_layers=2,
                                       num_attention_heads=4, max_position_embeddings=256,
                                       vision=VisionConfig.tiny()),
                      sam=SamConfig.tiny())


def _weights(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("shape", [(512, 256), (3, 256, 512)])
def test_quantize_int4_pack_unpack_match_jax(shape):
    w = _weights(0, shape)
    got = pquant.quantize_int4(torch.from_numpy(w))
    want = jquant.quantize_int4(jnp.asarray(w))
    for key in ("q4", "s4"):
        assert got[key].dtype == torch.from_numpy(np.array(want[key])).dtype
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    q = np.random.default_rng(1).integers(-8, 8, size=(512, 256)).astype(np.int8)
    packed = pw4.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jw4.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(pw4.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        pw4.unpack_int4(packed).numpy(), np.asarray(jw4.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("bf16", [False, True])
def test_w4_matmul_plain_matches_jax(bf16):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 512)).astype(np.float32)
    if bf16:
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    qw = jquant.quantize_int4(jnp.asarray(_weights(5, (512, 512))))
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    got = pw4.w4_matmul_plain(tx, torch.from_numpy(np.array(qw["q4"])),
                              torch.from_numpy(np.array(qw["s4"])))
    assert got.dtype == tx.dtype and got.shape == (16, 512)
    xla = np.asarray(jw4.w4_matmul_xla(jx, qw["q4"], qw["s4"])).astype(np.float32)
    kernel = np.asarray(jw4.w4_matmul(jx, qw["q4"], qw["s4"])).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), xla, **(BF16_STEP if bf16 else FP32))
    np.testing.assert_allclose(got.float().numpy(), kernel,
                               **(BF16_STEP if bf16 else dict(atol=1e-2, rtol=0)))


@pytest.mark.parametrize("bf16", [False, True])
def test_qdot_w4_and_w8a8_match_jax(bf16):
    """``qdot`` over int4 leaves (odd M: the reference pads it for its
    kernel tile) and W8A8 over int8 leaves, with a (2, 7) leading shape."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 512)).astype(np.float32)
    if bf16:
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    w = jnp.asarray(_weights(7, (512, 256)))
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    to_t = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    q4, q8 = jquant.quantize_int4(w), jquant.quantize_int8(w)
    got = pquant.qdot(tx, to_t(q4))
    assert got.shape == (2, 7, 256) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jquant.qdot(jx, q4)).astype(np.float32),
                               **(BF16_STEP if bf16 else FP32))
    got8 = pquant.qdot(tx, to_t(q8), act_quant=True)
    want8 = np.asarray(jquant.qdot(jx, q8, act_quant=True)).astype(np.float32)
    np.testing.assert_array_equal(got8.float().numpy(), want8)
    # act_quant applies to int8 weights only; int4 and plain weights ignore it
    torch.testing.assert_close(pquant.qdot(tx, to_t(q4), act_quant=True), got, rtol=0, atol=0)


@pytest.fixture(scope="module")
def int4_trees():
    """(config, fp32 tree, the same tree with its LLM quantized to 4 bits by
    the JAX package), as numpy."""
    cfg = w4_config()
    tree = numpy_params(cfg, 3)
    qtree = {**tree, "cogvlm": jax.tree.map(np.asarray, jquant.quantize_llm_for_serving(
        jax.tree.map(jnp.asarray, tree["cogvlm"]), release_originals=False, bits=4))}
    return cfg, tree, qtree


def test_quantize_llm_for_serving_bits4_matches_jax(int4_trees):
    cfg, tree, qtree = int4_trees
    cog = params_from_jax(tree, "cpu", cfg=cfg)["cogvlm"]
    got = _flatten(pquant.quantize_llm_for_serving(cog, release_originals=False, bits=4))
    want = _flatten(qtree["cogvlm"])
    assert got.keys() == want.keys()
    assert sum(k.endswith("/q4") for k in want) == 10 and "llm/lm_head/q" in want
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_params_from_jax_consumes_int4_tree(int4_trees):
    """A ``bits=4`` tree bridges leaf for leaf (``{q4, s4}`` experts, an int8
    ``lm_head``); a ``q4`` leaf of the wrong shape is refused."""
    cfg, _, qtree = int4_trees
    params = params_from_jax(qtree, "cpu", cfg=cfg)
    pflat, qflat = _flatten(params), _flatten(qtree)
    assert pflat.keys() == qflat.keys()
    for k, v in qflat.items():
        np.testing.assert_array_equal(pflat[k].numpy(), v, err_msg=k)
    assert pflat["cogvlm/llm/layers/lang_mlp/down/q4"].shape == (2, 256, 256)
    assert pflat["cogvlm/llm/layers/lang_mlp/down/s4"].shape == (2, 4, 256)
    bad = jax.tree.map(lambda a: a, qtree)
    bad["cogvlm"]["llm"]["layers"]["lang_qkv"]["q4"] = np.zeros((2, 256, 768), np.int8)
    with pytest.raises(ValueError, match="lang_qkv/q4 has shape"):
        params_from_jax(bad, "cpu", cfg=cfg)
