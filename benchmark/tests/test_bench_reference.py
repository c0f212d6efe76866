"""The plain reference against the port's CPU path at small widths: in fp32
they agree to rounding, piece by piece and through a whole run."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import run
from benchmark import weights as W
from benchmark.reference import vividmed as R


def _fp32(spec, bits):
    spec["cfg"].update(dtype="float32", llm_weight_bits=bits)
    spec["traffic"]["image_dtype"] = "float32"
    return spec


@pytest.mark.parametrize("bits", [16, 8])
def test_whole_run_in_fp32_matches_the_reference(small_spec, bits):
    out = run.execute(_fp32(small_spec, bits), 7_000_000_001, 0.3, False, device="cpu",
                      t0=time.perf_counter())
    assert out["check"]["logit_gap"]["value"] == 0.0
    assert out["check"]["mask_err"]["value"] < 1e-3
    assert out["correct"]


def _port_cfg(cfg):
    from mmmm_tpu_torch.models.cogvlm.config import CogVLMConfig, VisionConfig
    from mmmm_tpu_torch.models.segvol import SamConfig

    t = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    vlm = CogVLMConfig(**{k: v for k, v in t(cfg["vlm"]).items() if k != "vision"},
                       vision=VisionConfig(**t(cfg["vlm"]["vision"])))
    return vlm, SamConfig(**t(cfg["sam"]))


def test_pieces_match_the_port(small_spec):
    from mmmm_tpu_torch.models.cogvlm.decoder import llm_forward
    from mmmm_tpu_torch.models.cogvlm.vit import vit_forward
    from mmmm_tpu_torch.models.mmmm import vg_project
    from mmmm_tpu_torch.models.segvol.sam import sam_forward

    cfg = _fp32(small_spec, 16)["cfg"]
    vlm, sam = _port_cfg(cfg)
    params = W.make_tree(cfg, 11, "cpu")
    ref = R.Reference(cfg, 11, "cpu")
    g = torch.Generator().manual_seed(0)
    img = torch.randn((2, 3, 8, 16, 16), generator=g)
    a = vit_forward(params["cogvlm"]["vision"], vlm, img, (4, 4, 4), (2, 2, 2))
    torch.testing.assert_close(a, ref.vision_tokens(img, (4, 4, 4), (2, 2, 2)), rtol=1e-4,
                               atol=1e-4)
    prompts = torch.randn((2, 3, 32), generator=g)
    a = sam_forward(params["sam"], sam, img, (4, 4, 4), prompts)[0]
    torch.testing.assert_close(a, ref.sam_masks(img, (4, 4, 4), prompts), rtol=1e-4, atol=1e-4)
    h = torch.randn((2, 3, 256), generator=g)
    torch.testing.assert_close(vg_project(params, h), ref.vg_project(h))
    s = 10
    x = torch.randn((2, s, 256), generator=g)
    tt = torch.zeros((2, s), dtype=torch.long)
    tt[:, 1:4] = 1
    pos = torch.arange(s)[None].repeat(2, 1)
    seg = torch.ones((2, s), dtype=torch.int32)
    seg[1, 7:] = 0
    a = llm_forward(params["cogvlm"]["llm"], vlm, x, tt, pos, seg, attn_impl="xla")
    b = ref.llm_hidden(x, tt, pos, seg.bool())
    torch.testing.assert_close(a[0], b[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a[1, :7], b[1, :7], rtol=1e-4, atol=1e-4)


def test_int8_weights_are_the_ports():
    from mmmm_tpu_torch.ops.quant import quantize_int8

    w = torch.randn((64, 48), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    q = quantize_int8(w)
    torch.testing.assert_close(R.int8_weight(w), q["q"].float() * q["s"], rtol=0, atol=0)


def test_positions_hold_at_tags():
    assert R.continue_positions(10, 5, [7, 90, 8, 91, 9], bop=90, eop=91) == [11, 12, 12, 12, 13]
