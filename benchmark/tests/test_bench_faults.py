"""The check catches what it is there to catch. At widths a CPU test holds,
a run of the program comes out correct; its control (the W4A16 weights in
place of the configuration's W8A16) and each fault planted under the timed
path come out not correct. The harness's look for a card is skipped: the
run goes through ``run.execute`` on the CPU."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import run

SEED = 8_000_000_003


def _run(spec, control=None):
    return run.execute(spec, SEED, 0.3, False, device="cpu", control=control,
                       t0=time.perf_counter())


def test_program_is_correct(small_spec):
    out = _run(small_spec)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


def test_control_is_not_correct(small_spec):
    out = _run(small_spec, control="w4")
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for k, c in out["check"].items() if k != "requests_checked")


def _altered_token(monkeypatch):
    """The first token of the first row becomes the least likely one."""
    import mmmm_tpu_torch.models.generate as gen

    real = gen.vocab_argmax

    def argmax(logits):
        out = real(logits)
        if out.dim() == 1:
            out = out.clone()
            out[0] = logits[0].argmin()
        return out

    monkeypatch.setattr(gen, "vocab_argmax", argmax)


def _half_batch(monkeypatch):
    """Only the first half of each batch is served; its answers are handed
    out for the rest too."""
    import mmmm_tpu_torch.models.inference as inf

    real = inf.generate_grounded

    def generate(params, cfg, tok, ids, tt, pos, lens, image, *a, grounding_image=None, **kw):
        h = ids.shape[0] // 2
        res = real(params, cfg, tok, ids[:h], tt[:h], pos[:h], lens[:h], image[:h], *a,
                   grounding_image=grounding_image[:h], **kw)
        twice = lambda x: None if x is None else (
            torch.cat([x, x]) if torch.is_tensor(x) else __import__("numpy").concatenate([x, x]))
        res.tokens, res.num_generated = twice(res.tokens), twice(res.num_generated)
        res.masks = twice(res.masks)
        return res

    monkeypatch.setattr(inf, "generate_grounded", generate)


def _unchanged_state(monkeypatch):
    """Each verify window attends over the cache but leaves it as it was."""
    import mmmm_tpu_torch.models.cogvlm.decoder as dec

    real = dec.decode_attention_window_append
    monkeypatch.setattr(dec, "decode_attention_window_append",
                        lambda q, kc, vc, *a, **kw: real(q, kc.clone(), vc.clone(), *a, **kw))


@pytest.mark.parametrize("fault", [_altered_token, _half_batch, _unchanged_state],
                         ids=["token_altered", "half_batch", "state_unchanged"])
def test_fault_is_not_correct(small_spec, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(small_spec)
    assert not out["correct"], out["check"]


def test_the_control_on_the_card(small_spec, cuda):
    """The same at the small widths on the card, where the kernels run."""
    ok = run.execute(small_spec, SEED, 0.3, False, device="cuda", t0=time.perf_counter())
    bad = run.execute(small_spec, SEED, 0.3, False, device="cuda", control="w4",
                      t0=time.perf_counter())
    assert ok["correct"] and not bad["correct"]
