"""LLM-judge metrics (the reference's ``LlamaMetrics``).

The reference scores VQA answers and reports with a Llama-3-70B judge served
by vLLM over 4 GPUs (``scripts/evaluate/utils.py:198-288``): binary 0/1
correctness for closed questions and 0-10 quality scores for open answers.

The judge is any callable ``generate(prompts) -> completions``: a
locally-served LLM, the port's batched text-only generation
(``models/llm_batch.py make_text_generator``), or a stub. Prompt construction, score parsing,
and aggregation live here and are fully testable offline.
"""
from __future__ import annotations

import re
from typing import Callable, Sequence

JUDGE_SYSTEM_PROMPT = (
    "You are an impartial medical expert grading the quality of answers to "
    "questions about medical images."
)

BINARY_PROMPT = (
    "Question: {question}\n"
    "Reference answer: {reference}\n"
    "Candidate answer: {prediction}\n"
    "Does the candidate answer convey the same meaning as the reference "
    "answer? Reply with exactly one character: 1 for yes, 0 for no."
)

SCALE_PROMPT = (
    "Question: {question}\n"
    "Reference answer: {reference}\n"
    "Candidate answer: {prediction}\n"
    "Rate how well the candidate answer matches the reference on a scale of "
    "0 to 10, where 10 is a perfect match. Reply with only the number."
)


def parse_binary(completion: str) -> float | None:
    m = re.search(r"[01]", completion.strip())
    return float(m.group()) if m else None


def parse_scale(completion: str) -> float | None:
    m = re.search(r"\b(10|\d)\b", completion.strip())
    return float(m.group()) / 10.0 if m else None


class LLMJudge:
    def __init__(self, generate_fn: Callable[[Sequence[str]], Sequence[str]]):
        """``generate_fn``: batch of prompts -> batch of completions."""
        self.generate_fn = generate_fn

    def _prompts(self, template, rows):
        return [
            f"{JUDGE_SYSTEM_PROMPT}\n\n" + template.format(**r) for r in rows
        ]

    def score_binary(self, rows: list[dict]) -> dict[str, float]:
        """rows: {question, reference, prediction} -> accuracy over parseable."""
        outs = self.generate_fn(self._prompts(BINARY_PROMPT, rows))
        scores = [s for o in outs if (s := parse_binary(o)) is not None]
        return {
            "judge_accuracy": sum(scores) / len(scores) if scores else 0.0,
            "judge_parse_rate": len(scores) / max(len(rows), 1),
        }

    def score_scale(self, rows: list[dict]) -> dict[str, float]:
        outs = self.generate_fn(self._prompts(SCALE_PROMPT, rows))
        scores = [s for o in outs if (s := parse_scale(o)) is not None]
        return {
            "judge_score": sum(scores) / len(scores) if scores else 0.0,
            "judge_parse_rate": len(scores) / max(len(rows), 1),
        }
