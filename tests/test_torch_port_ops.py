"""The port's plain ops (norm, rope, gelu, resample) against the JAX package.

The same numpy inputs, made from a seed, go through ``mmmm_tpu.ops`` and
``mmmm_tpu_torch.ops`` on the CPU; fp32 agrees to atol = rtol = 1e-5 and
bf16 GELU to within one bf16 ulp.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.ops import gelu as jgelu
from mmmm_tpu.ops import norm as jnorm
from mmmm_tpu.ops import resample as jres
from mmmm_tpu.ops import rope as jrope
from mmmm_tpu_torch.ops import gelu as pgelu
from mmmm_tpu_torch.ops import norm as pnorm
from mmmm_tpu_torch.ops import resample as pres
from mmmm_tpu_torch.ops import rope as prope

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 64)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape), _rand(rng, shape[-1])
    _close(pnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 7, 32), _rand(rng, 32), _rand(rng, 32)
    pw, pb = (torch.from_numpy(w), torch.from_numpy(b)) if affine else (None, None)
    jw, jb = (jnp.asarray(w), jnp.asarray(b)) if affine else (None, None)
    _close(pnorm.layer_norm(torch.from_numpy(x), pw, pb, 1e-6),
           jnorm.layer_norm(jnp.asarray(x), jw, jb, 1e-6))


def test_rope():
    rng = np.random.default_rng(2)
    q, k = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 6, 4, 16)
    pos = rng.integers(0, 40, size=(2, 6)).astype(np.int32)
    jcos, jsin = jrope.rope_cos_sin(64, 16)
    pcos, psin = prope.rope_cos_sin(64, 16)
    _close(pcos, jcos)
    _close(psin, jsin)
    pq, pk = prope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), pcos, psin,
                              torch.from_numpy(pos))
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin, jnp.asarray(pos))
    _close(pq, jq)
    _close(pk, jk)


def test_gelu_fp32_is_erf():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    _close(pgelu.gelu(torch.from_numpy(x)), jgelu.gelu(jnp.asarray(x)))


def test_gelu_bf16_within_one_ulp_everywhere():
    """Every finite bf16 input: the port's fitted GELU is within one bf16 ulp
    of the JAX package's. Subnormals count as 0 on both sides: XLA on the
    CPU flushes them, PyTorch does not (mmmm_tpu/ops/gelu.py documents the
    flush). The fp32 intermediates near the smallest normal flush too, so
    outputs below twice the smallest normal count as 0."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    xb = bits.view(ml_dtypes.bfloat16)
    finite = np.isfinite(xb.astype(np.float32))
    ref = np.asarray(jgelu.gelu(jnp.asarray(xb[finite]))).astype(np.float32)
    xt = torch.from_numpy(bits[finite].view(np.int16)).view(torch.bfloat16)
    out = pgelu.gelu(xt)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    tiny = np.finfo(np.float32).tiny
    ref, got = (np.where(np.abs(v) < 2 * tiny, 0.0, v) for v in (ref, got))
    mag = np.maximum(np.abs(ref), np.abs(got))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


@pytest.mark.parametrize("old,new", [(35, 32), (4, 9), (5, 5), (8, 2)])
def test_linear_interp_matrix(old, new):
    np.testing.assert_array_equal(pres._linear_interp_matrix(old, new),
                                  np.asarray(jres._linear_interp_matrix(old, new)))


@pytest.mark.parametrize("shape,scale", [((2, 3, 4), False), ((8, 6, 6), True), ((4, 5, 5), False)])
def test_resample_nd(shape, scale):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 3, 4, 5, 5)
    _close(pres.resample_nd(torch.from_numpy(x), shape, scale),
           jres.resample_nd(jnp.asarray(x), shape, scale))


def test_trilinear_resize():
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, 2, 4, 4)
    _close(pres.trilinear_resize(torch.from_numpy(x), (4, 16, 16)),
           jres.trilinear_resize(jnp.asarray(x), (4, 16, 16)))


@pytest.mark.parametrize("pz", [4, 2, 1])
def test_collapse_and_patch_embed(pz):
    rng = np.random.default_rng(5)
    w, b = _rand(rng, 8, 3, 4, 4, 4), _rand(rng, 8)
    x = _rand(rng, 2, 3, 4, 8, 12)
    _close(pres.collapse_patch_weight_z(torch.from_numpy(w), pz),
           jres.collapse_patch_weight_z(jnp.asarray(w), pz))
    _close(pres.variable_patch_embed_3d(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(b), (pz, 4, 4)),
           jres.variable_patch_embed_3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        (pz, 4, 4)))


@pytest.mark.parametrize("pz,cnt", [(1, 0), (4, 0), (4, 1), (16, 1)])
def test_variable_upsample(pz, cnt):
    rng = np.random.default_rng(6)
    w, b = _rand(rng, 8, 4, 2, 2, 2), _rand(rng, 4)
    x = _rand(rng, 2, 8, 2, 3, 3)
    _close(pres.variable_upsample_3d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), pz, cnt),
           jres.variable_upsample_3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pz, cnt))
