"""The traffic generator: the same seed gives the same inputs, another seed
other inputs over the same set of prompt lengths, and every seed the same
model. What the driver or the reference does not model is refused."""
from __future__ import annotations

import pytest
import torch

from benchmark.kinds.grounded_reports import Workload


def _pool(spec, seed):
    wl = Workload(spec["cfg"], spec["traffic"], seed, "cpu")
    return wl._make_pool(), wl


def test_same_seed_same_inputs(small_spec):
    a, _ = _pool(small_spec, 5_000_000_001)
    b, _ = _pool(small_spec, 5_000_000_001)
    for x, y in zip(a, b):
        assert torch.equal(x.ids, y.ids) and torch.equal(x.pos, y.pos)
        assert torch.equal(x.image, y.image) and torch.equal(x.g_image, y.g_image)
        assert x.lens_host == y.lens_host


def test_other_seed_other_inputs_same_lengths(small_spec):
    a, wl = _pool(small_spec, 5_000_000_001)
    b, _ = _pool(small_spec, 5_000_000_002)
    assert not torch.equal(a[0].image, b[0].image)
    assert not all(torch.equal(x.ids, y.ids) for x, y in zip(a, b))
    la = sorted(n for x in a for n in x.lens_host)
    lb = sorted(n for x in b for n in x.lens_host)
    assert la == lb
    # the window opens on the batch holding the longest prompt
    first = small_spec["traffic"]["warmup_batches"] % len(a)
    assert max(a[first].lens_host) == la[-1]
    wl.pool = a
    assert 0 in wl._keep_indices()


def test_content_seed_deals_the_same_batches(small_spec):
    small_spec["traffic"]["content_seed"] = 11
    a, _ = _pool(small_spec, 5_000_000_001)
    b, _ = _pool(small_spec, 5_000_000_002)
    studies = lambda pool: sorted(
        sorted((tuple(x.ids[r].tolist()), float(x.image[r].sum())) for r in range(len(x.lens_host)))
        for x in pool)
    assert studies(a) == studies(b)
    order = lambda pool: [x.ids.tolist() for x in pool]
    seeds = [_pool(small_spec, 5_000_000_001 + i)[0] for i in range(6)]
    assert len({str(order(p)) for p in seeds}) > 1
    first = small_spec["traffic"]["warmup_batches"] % len(a)
    assert max(a[first].lens_host) == max(n for x in a for n in x.lens_host)


def test_prompt_layout(small_spec):
    pool, _ = _pool(small_spec, 7)
    tr = small_spec["traffic"]
    n_vis = tr["vision_tokens"]
    for batch in pool:
        for r, n in enumerate(batch.lens_host):
            assert batch.ids[r, 0] == 1 and (batch.ids[r, 1:1 + n_vis] == 3).all()
            assert (batch.tt[r, 1:1 + n_vis] == 1).all() and batch.tt[r, 1 + n_vis:].sum() == 0
            assert batch.pos[r, n - 1] == 3 + (n - 1 - n_vis)
            assert (batch.ids[r, 1 + n_vis:n] >= 4).all()
            assert (batch.ids[r, 1 + n_vis:n] < small_spec["cfg"]["special_tokens_base"]).all()


def test_every_seed_serves_the_same_model(small_spec):
    from benchmark import weights as W

    a = Workload(small_spec["cfg"], small_spec["traffic"], 5_000_000_001, "cpu")
    b = Workload(small_spec["cfg"], small_spec["traffic"], 5_000_000_002, "cpu")
    assert a.weight_seed == b.weight_seed == small_spec["cfg"]["weight_seed"]
    leaf = W.model_spec(small_spec["cfg"])["cogvlm/llm/lm_head"]
    head = W.draw(small_spec["cfg"], a.weight_seed, "cogvlm/llm/lm_head", leaf, None, "cpu")
    plain = dict(small_spec["cfg"], head_bias={})
    unbiased = W.draw(plain, a.weight_seed, "cogvlm/llm/lm_head", leaf, None, "cpu")
    for tok, bias in small_spec["cfg"]["head_bias"].items():
        shift = head[:, int(tok)].float() - unbiased[:, int(tok)].float()
        assert (shift - bias).abs().max() <= 2 ** -5  # a bf16 step at the bias' size


def _unknown_traffic_key(spec):
    spec["traffic"]["arrivals"] = "poisson"


def _instance_grounding(spec):
    spec["traffic"]["generate"] = {"instance": True}


def _unknown_limit(spec):
    spec["traffic"]["check"]["limits"]["box_err"] = 0.1


def _int4_weights(spec):
    spec["cfg"]["llm_weight_bits"] = 4


def _bf16_grounding(spec):
    spec["cfg"]["grounding_dtype"] = "bfloat16"


@pytest.mark.parametrize("change", [_unknown_traffic_key, _instance_grounding, _unknown_limit,
                                    _int4_weights, _bf16_grounding],
                         ids=["traffic_key", "instance", "limit", "int4", "sam_bf16"])
def test_what_the_driver_or_reference_does_not_model_is_refused(small_spec, change):
    change(small_spec)
    with pytest.raises(ValueError):
        Workload(small_spec["cfg"], small_spec["traffic"], 5_000_000_001, "cpu")


def test_generate_options_reach_the_program(small_spec):
    small_spec["traffic"]["generate"] = {"prefill_chunk": 1, "w8a8": True}
    wl = Workload(small_spec["cfg"], small_spec["traffic"], 5_000_000_001, "cpu")
    seen = {}
    wl.generate = lambda *a, **kw: seen.update(kw)
    wl.program = wl.mcfg = wl.tok = None
    wl._run(wl._make_pool()[0])
    assert seen["prefill_chunk"] == 1 and seen["w8a8"] is True
