"""The reference's non-default numeric switches in the port, against the JAX
package on the CPU: the GELU modes (``MMMM_GELU``, ``MMMM_FAST_GELU``), K4's
and K12's fast softmax (``MMMM_DENSE_FAST_SOFTMAX``) and K9's bf16 cast
(``MMMM_Q8_CAST``, on the ragged route ``MMMM_RAGGED_DECODE=1`` selects),
as the port's keywords ``gelu_mode``, ``dense_fast_softmax`` and
``q8_cast``.

Tolerances, each with its reason:

- GELU, against the JAX function run op by op: fp32 within 1e-6 absolute
  (two fp32 steps at |x| = 7; the erf and tanh chains round their
  intermediates in another order); bf16 within one bf16 step (JAX rounds
  each op of the chain to bf16, the port rounds once). Under ``jax.jit``
  this CPU's XLA takes a coarser tanh, 4.7e-4 off in the tail.
- K4 / K12 fast softmax, the port's plain version against the Pallas
  kernels in interpret mode with ``MMMM_DENSE_FAST_SOFTMAX=1``: 1e-3 of the
  largest output in fp32 (XLA on the CPU may keep the bf16 ``p`` in fp32
  where it is summed or cast back, the excess precision it allows; the
  port rounds it, as the TPU does: 2^-9 of a ``p``, averaged over a row),
  one bf16 step in bf16.
- K9 ``cast="bf16"`` against ``decode_attention_pallas_q8_ragged(cast=
  "bf16")``. XLA on the CPU keeps the kernel's explicit roundings (q and
  the weights ``w`` to bf16) but computes each product of two bf16 values
  in fp32 where its result is cast to fp32 next (its excess precision
  removes the convert pair). So the port's formula with its product
  rounding switched off (``_q8_bf16_plain(round_products=False)``) is held
  to the interpret-mode kernel over one block, read alone and after the
  fused append: 1e-6 with fp32 q (1.2e-7 measured); with bf16 q, one bf16
  step of an output (its own rounding, where the fp32 value lies at a
  boundary) and under 1% of the outputs off at all. The whole plain version,
  which rounds each product as the TPU does, is held to it within 2e-2:
  that rounding alone moves it 5.4e-3 (measured), and blocks of 16 slots
  round their weights against the running max where the port takes the
  row's.
- ``generate_grounded`` with the three switches against the JAX run with
  the matching environment (its encoder sites patched to the dense Pallas
  kernel, as ``"auto"`` takes it on the TPU; the decode on the ragged
  Pallas route): tokens, texts and targets identical, masks within 2e-4.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu.models.cogvlm import vit as jvit
from mmmm_tpu.models.segvol import encoder as jenc
from mmmm_tpu.ops import decode_kernel as jdec
from mmmm_tpu.ops import dense_attn as jdense
from mmmm_tpu.ops import gelu as jgelu
from mmmm_tpu.ops import quant as jquant
from mmmm_tpu_torch.ops import decode_kernel as pdec
from mmmm_tpu_torch.ops import dense_attn as pdense
from mmmm_tpu_torch.ops import gelu as pgelu
from mmmm_tpu_torch.ops.numerics import Numerics, current, numerics
from test_torch_port_capacity import _compare, _fixture_tree, jax_env, tiny_trees  # noqa: F401
from test_torch_port_kernel_shapes import _torch_of
from test_torch_port_remat import one_thread  # noqa: F401

BF16_STEP = dict(atol=2 ** -7, rtol=2 ** -8)


# ---- GELU --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("env,mode", [({}, "auto"), ({"MMMM_GELU": "fitted"}, "fitted"),
                                      ({"MMMM_GELU": "tanh"}, "tanh"),
                                      ({"MMMM_FAST_GELU": "1"}, "tanh"),
                                      ({"MMMM_GELU": "erf"}, "erf")])
def test_gelu_modes_match_jax(monkeypatch, env, mode, dtype):
    for k in ("MMMM_GELU", "MMMM_FAST_GELU"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = np.linspace(-7, 7, 4001, dtype=np.float32)
    x = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    want = np.asarray(jgelu.gelu(jnp.asarray(x)), np.float32)
    with numerics(gelu_mode=mode):
        got = pgelu.gelu(_torch_of(x)).float().numpy()
    tol = BF16_STEP if dtype == "bfloat16" else dict(atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, **tol)
    assert current() == Numerics()  # the setting ends with the block


def test_gelu_modes_differ_and_refuse_unknown():
    x = torch.linspace(-3, 3, 101)
    outs = {m: pgelu.gelu(x, m) for m in ("fitted", "tanh", "erf")}
    assert not torch.equal(outs["tanh"], outs["erf"]) and not torch.equal(outs["fitted"],
                                                                          outs["erf"])
    assert torch.equal(pgelu.gelu(x), outs["erf"])  # "auto" in fp32
    with pytest.raises(ValueError, match="gelu_mode"):
        with numerics(gelu_mode="fast"):
            pass
    with pytest.raises(ValueError, match="q8_cast"):
        Numerics(q8_cast="fp16")


# ---- K4 / K12 fast softmax ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_fast_softmax_matches_pallas(monkeypatch, dtype):
    """The plain fast form against K4 (``dense_attention``, the bhsd kernel)
    and K12 (``_dense_fwd_bshd``) in interpret mode, over a ragged S; the
    exact form is further from them than the tolerance in fp32."""
    monkeypatch.setenv("MMMM_DENSE_FAST_SOFTMAX", "1")
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 150, 8, 64
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) * 1.5 for _ in range(3))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(t, jdt) for t in (q, k, v))
    scale = d ** -0.5
    k4 = np.asarray(jdense.dense_attention(jq, jk, jv, scale), np.float32)
    k12 = np.asarray(jdense._dense_fwd_bshd(jq, jk, jv, scale), np.float32)
    pq, pk, pv = (torch.from_numpy(np.asarray(t.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32) for t in (jq, jk, jv))
    got = pdense.dense_attention(pq, pk, pv, scale, fast_softmax=True).float().numpy()
    exact = pdense.dense_attention(pq, pk, pv, scale).float().numpy()
    top = np.abs(k4).max()
    tol = BF16_STEP if dtype == "bfloat16" else dict(atol=1e-3 * top, rtol=0)
    for ref in (k4, k12):
        np.testing.assert_allclose(got, ref, **tol)
    if dtype == "float32":
        assert np.abs(exact - k4).max() > np.abs(got - k4).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_fast_tiles_is_the_fast_form_in_key_tiles(monkeypatch, dtype):
    """``dense_attention_fast_tiles`` (what K4's fast form is held to on the
    card): over one key tile it is the plain fast form bit for bit; over
    several it stays within 4e-3 of the largest output of the Pallas K4 (a
    probability moves by at most 2^-8 / e where the running max rounds
    ``s - m`` elsewhere) and nearer to it than the exact form in the mean."""
    monkeypatch.setenv("MMMM_DENSE_FAST_SOFTMAX", "1")
    g = torch.Generator().manual_seed(5)
    one = pdense.fast_softmax_key_tile(0, dtype)
    q, k, v = (torch.randn(2, one, 4, 32, generator=g).to(dtype) * 1.5 for _ in range(3))
    assert torch.equal(pdense.dense_attention_fast_tiles(q, k, v, 0.2),
                       pdense.dense_attention_plain(q, k, v, 0.2, fast_softmax=True))
    q, k, v = (torch.randn(2, 150, 4, 64, generator=g).to(dtype) * 1.5 for _ in range(3))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jdense.dense_attention(*(jnp.asarray(t.float().numpy(), jdt)
                                               for t in (q, k, v)), 0.125), np.float32)
    got = pdense.dense_attention_fast_tiles(q, k, v, 0.125).float().numpy()
    exact = pdense.dense_attention_plain(q, k, v, 0.125).float().numpy()
    np.testing.assert_allclose(got, want, atol=4e-3 * np.abs(want).max(), rtol=0)
    assert np.abs(got - want).mean() < np.abs(exact - want).mean()


# ---- K9 bf16 cast -----------------------------------------------------------------------

def _q8_inputs(rng, b, h, smax, d, bf16):
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    if bf16:
        q = q.astype(ml_dtypes.bfloat16)
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(b, h, smax, d)), jnp.bfloat16))
    return q, [kq, ks, vq, vs]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("smax,d,block_s", [(64, 128, 64), (64, 128, 16), (48, 90, 48)])
def test_q8_bf16_cast_matches_pallas(smax, d, block_s, bf16):
    rng = np.random.default_rng(smax + d + block_s)
    b, h = 3, 8
    q, leaves = _q8_inputs(rng, b, h, smax, d, bf16)
    kv_len = np.array([0, smax // 2 + 3, smax], np.int32)
    ref = jdec.decode_attention_pallas_q8_ragged(jnp.asarray(q), *leaves, jnp.asarray(kv_len),
                                                 block_s=block_s, cast="bf16")
    got = pdec.decode_attention_q8(_torch_of(q), *map(_torch_of, leaves),
                                   torch.from_numpy(kv_len), cast="bf16", q8_mxu=True)
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2,
                               rtol=0)
    f32 = pdec.decode_attention_q8(_torch_of(q), *map(_torch_of, leaves),
                                   torch.from_numpy(kv_len))
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("bf16", [False, True])
def test_q8_bf16_cast_append_fused_matches_pallas(bf16):
    """The fused step's plain version in bf16 against the JAX package's
    ``quantize_kv``, ``kv_append_pallas_q8`` and the bf16 ragged read over
    one block: the cache bit for bit, the output within the read's
    tolerance."""
    rng = np.random.default_rng(11)
    b, h, smax, d = 3, 8, 64, 128
    q, leaves = _q8_inputs(rng, b, h, smax, d, bf16)
    dt = ml_dtypes.bfloat16 if bf16 else np.float32
    kn, vn = (rng.normal(size=(b, 1, h, d)).astype(dt) for _ in range(2))
    widx = np.array([5, 63, 20], np.int32)
    kv_len = np.array([6, 64, 21], np.int32)
    (jkq, jks), (jvq, jvs) = (jquant.quantize_kv(jnp.swapaxes(jnp.asarray(t), 1, 2))
                              for t in (kn, vn))
    jcache = jdec.kv_append_pallas_q8(dict(zip(pdec.Q8_LEAVES, leaves)), jkq, jks, jvq, jvs,
                                      jnp.asarray(widx))
    jleaves = [jcache[key] for key in pdec.Q8_LEAVES]
    ref = jdec.decode_attention_pallas_q8_ragged(jnp.asarray(q), *jleaves, jnp.asarray(kv_len),
                                                 block_s=smax, cast="bf16")
    cache = dict(zip(pdec.Q8_LEAVES, map(_torch_of, leaves)))
    got = pdec.decode_attention_q8_append(_torch_of(q), cache, _torch_of(kn), _torch_of(vn),
                                          torch.from_numpy(widx), torch.from_numpy(kv_len),
                                          cast="bf16")
    for key, want in zip(pdec.Q8_LEAVES, jleaves):
        assert torch.equal(cache[key], _torch_of(want)), key
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("smax,d,fused", [(64, 128, False), (48, 90, False), (64, 128, True)])
def test_q8_bf16_formula_without_product_rounding_matches_pallas(smax, d, fused, bf16):
    """The bf16 formula with unrounded products (every other rounding kept)
    against the interpret-mode kernel over one block, read alone and after
    the JAX package's fused-step append."""
    rng = np.random.default_rng(smax + d + 7 * fused)
    b, h = 3, 8
    q, leaves = _q8_inputs(rng, b, h, smax, d, bf16)
    kv_len = np.array([0, smax // 2 + 3, smax], np.int32)
    if fused:
        kn, vn = (rng.normal(size=(b, h, 1, d)).astype(np.float32) for _ in range(2))
        (jkq, jks), (jvq, jvs) = (jquant.quantize_kv(jnp.asarray(t, jnp.bfloat16))
                                  for t in (kn, vn))
        jcache = jdec.kv_append_pallas_q8(dict(zip(pdec.Q8_LEAVES, leaves)), jkq, jks, jvq,
                                          jvs, jnp.asarray(kv_len - 1))
        leaves = [jcache[key] for key in pdec.Q8_LEAVES]
    ref = jdec.decode_attention_pallas_q8_ragged(jnp.asarray(q), *leaves, jnp.asarray(kv_len),
                                                 block_s=smax, cast="bf16")
    tq = _torch_of(q)
    kq, ks, vq, vs = map(_torch_of, leaves)
    valid = (torch.arange(smax)[None, :] < torch.from_numpy(kv_len)[:, None].long())
    got = pdec._q8_bf16_plain(tq.float().transpose(1, 2), kq, ks, vq, vs, valid[:, None, None],
                              d ** -0.5, round_products=False).transpose(1, 2).to(tq.dtype)
    want = np.asarray(ref, np.float32)
    tol = dict(atol=1e-7, rtol=2 ** -7) if bf16 else dict(atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    if bf16:  # a step only where the fp32 value lies at a rounding boundary
        assert np.mean(got.float().numpy() != want) < 1e-2
    rounded = pdec.decode_attention_q8_plain(tq, kq, ks, vq, vs, torch.from_numpy(kv_len),
                                             cast="bf16")
    assert not torch.equal(rounded, got)


# ---- generate_grounded with the switches --------------------------------------------

@pytest.fixture
def jax_dense_sites(monkeypatch):
    """The JAX encoder sites (EVA ViT, SAM encoder) on the dense Pallas
    kernel, in interpret mode, where ``"auto"`` takes it on the TPU."""
    for mod in (jvit, jenc):
        orig = mod.segment_attention

        def site(q, k, v, seg, *a, orig=orig, all_valid=False, causal=False, scale=None,
                 **kw):
            if all_valid and not causal and jdense.fits_dense_kernel(q.shape[1], q.shape[-1]):
                return jdense.dense_attention(q, k, v,
                                              q.shape[-1] ** -0.5 if scale is None else scale)
            return orig(q, k, v, seg, *a, all_valid=all_valid, causal=causal, scale=scale, **kw)

        monkeypatch.setattr(mod, "segment_attention", site)


def test_generate_grounded_with_the_switches_matches_jax(tiny_trees, jax_env, jax_dense_sites):
    """An int8 KV cache read by K9 in bf16, the fast softmax at the ViT and
    the SAM encoder, and the tanh GELU, against the reference run with
    ``MMMM_RAGGED_DECODE=1 MMMM_Q8_CAST=bf16 MMMM_DENSE_FAST_SOFTMAX=1
    MMMM_GELU=tanh``; the switches end with the call."""
    cfg, jcfg, tok = tiny_trees
    jax_env(MMMM_RAGGED_DECODE="1", MMMM_Q8_CAST="bf16", MMMM_DENSE_FAST_SOFTMAX="1",
            MMMM_GELU="tanh")
    trees = _fixture_tree(cfg, tok)
    _compare(cfg, jcfg, *trees, attn_impl="pallas", kv_cache_dtype="int8",
             port_kw=dict(q8_cast="bf16", dense_fast_softmax=True, gelu_mode="tanh"))
    assert current() == Numerics()
