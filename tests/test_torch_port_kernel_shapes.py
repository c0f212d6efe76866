"""The shapes the port's redesigned kernels take, on the CPU.

Each wrapper decides with a plain function whether its CUDA kernel takes a
shape (``ops/w4_matmul.py route``, ``mma_takes``, ``gemv_takes``;
``ops/flash.py bwd_takes``) and raises on a CUDA tensor of any other shape.
These tests enumerate the shapes the flagship's main paths hand them, so
the card never raises there:

  - every int4 product of the W4A16 prefill (``quantize_llm_for_serving(
    bits=4)`` weights) at B = 4, whole and in chunks of 2 samples, with the
    static expert span the serving path passes and with the masked dual
    path, recorded from the port's own ``llm_prefill`` over a one-layer
    flagship-width LLM whose int4 leaves are meta tensors;
  - every flash site of the training step (LLM, ViT over an fp32 and a bf16
    image, SAM encoder) at the flagship and the tiny config;

and check that the predicates refuse shapes the kernels cannot take. The
plain ``_delta`` (K7delta's plain version) is held against the JAX
package's delta expression in ``_flash_bwd_impl``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu_torch.models.cogvlm import decoder as pdec
from mmmm_tpu_torch.models.cogvlm.config import CogVLMConfig
from mmmm_tpu_torch.models.segvol import SamConfig
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
    """(name, head dim, dtypes) of the training step's flash sites: the LLM
    in bf16, the ViT in fp32 (an fp32 image, as the data loaders pass) and
    in bf16 (a bf16 image), the SAM encoder in fp32."""
    return [("llm", vlm.head_dim, (torch.bfloat16,)),
            ("vit", vlm.vision.hidden_size // vlm.vision.num_heads,
             (torch.float32, torch.bfloat16)),
            ("sam", sam.embed_dim // sam.encoder_num_heads, (torch.float32,))]


@pytest.mark.parametrize("which", ["flagship", "tiny"])
def test_training_flash_sites_take_k7(which):
    if which == "flagship":
        vlm, sam = CogVLMConfig.cogvlm17b(), SamConfig()
        assert [d for _, d, _ in _training_sites(vlm, sam)] == [128, 112, 64]
    else:
        vlm, sam = CogVLMConfig.tiny(), SamConfig.tiny()
    for name, d, dtypes in _training_sites(vlm, sam):
        for dt in dtypes:
            assert pflash.bwd_takes(d, dt), (name, d, dt)


@pytest.mark.parametrize("d,dtype", [(20, torch.bfloat16), (136, torch.bfloat16),
                                     (130, torch.float32), (6, torch.float32),
                                     (64, torch.float16), (0, torch.float32)])
def test_k7_refuses(d, dtype):
    assert not pflash.bwd_takes(d, dtype)


@pytest.mark.parametrize("d,dtype", [(100, torch.bfloat16), (6, torch.float32)])
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
    assert pflash.bwd_takes(d, dtype)


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
