"""Report and VQA metrics, the port's copy of ``mmmm_tpu/eval`` (pure Python
and numpy; ``models.py`` imports ``transformers`` inside its scorers)."""
from .metrics import GenericMetrics, bleu, rouge_l, rouge_n, meteor, exact_match
from .cxr import CXRMetrics, KeywordChexpertLabeler, CHEXPERT_CONDITIONS
from .ct import CTMetrics, KeywordCTLabeler, CT_CONDITIONS
from .judge import LLMJudge
from .composite import (
    CompositeMetric,
    RADCLIQ_COLUMNS,
    load_radcliq,
    radcliq_scores,
    radgraph_reward,
)

__all__ = [
    "GenericMetrics",
    "bleu",
    "rouge_l",
    "rouge_n",
    "meteor",
    "exact_match",
    "CXRMetrics",
    "KeywordChexpertLabeler",
    "CHEXPERT_CONDITIONS",
    "CTMetrics",
    "KeywordCTLabeler",
    "CT_CONDITIONS",
    "LLMJudge",
    "CompositeMetric",
    "RADCLIQ_COLUMNS",
    "load_radcliq",
    "radcliq_scores",
    "radgraph_reward",
]
