"""The port's metrics (``mmmm_tpu_torch/eval``) against the JAX package's on
one fixed set of reports: every NLG metric, labeler, metric suite, the LLM
judge's parsing and scoring, the RadCliQ composite, the RadGraph annotator
and reward, compared as exact floats; and the model-backed scorers
(``eval/models.py``) on the tiny BERT state dicts of
``tests/test_eval_models.py``, on the CPU."""
import numpy as np
import pytest
import torch

import mmmm_tpu.eval as jeval
import mmmm_tpu_torch.eval as peval
from mmmm_tpu.eval import composite as jcomp
from mmmm_tpu.eval import judge as jjudge
from mmmm_tpu.eval import metrics as jmetrics
from mmmm_tpu.eval import radgraph as jradgraph
from mmmm_tpu_torch.eval import composite as pcomp
from mmmm_tpu_torch.eval import judge as pjudge
from mmmm_tpu_torch.eval import metrics as pmetrics
from mmmm_tpu_torch.eval import radgraph as pradgraph

PREDICTIONS = [
    "There is a small left pleural effusion. No pneumothorax.",
    "The heart size is normal. Lungs are clear without focal consolidation.",
    "Mild cardiomegaly with pulmonary edema; possible atelectasis at the right base.",
    "A 5 mm nodule in the right upper lobe. The liver is unremarkable.",
    "no acute findings",
    "Emphysema and a hiatal hernia. Coronary artery calcification is seen.",
    "",
]
REFERENCES = [
    "Small left pleural effusion, no pneumothorax seen.",
    "Normal heart size. The lungs are clear.",
    "Cardiomegaly and pulmonary edema. Right basilar atelectasis.",
    "Right upper lobe pulmonary nodule measuring 5 mm. Unremarkable liver and spleen.",
    "No acute cardiopulmonary process.",
    "Hiatal hernia. Coronary calcification. No emphysema.",
    "Support devices in place; fracture of the left rib.",
]
PAIRS = list(zip(PREDICTIONS, REFERENCES))


def _pairwise(mod, name, **kw):
    return [getattr(mod, name)(p, r, **kw) for p, r in PAIRS]


def _judge(mod):
    replies = iter(["1", "0 because", "maybe", "7", "10/10", "score: 3", "none"] * 4)
    judge = mod.LLMJudge(lambda prompts: [next(replies) for _ in prompts])
    rows = [{"question": "q", "reference": r, "prediction": p} for p, r in PAIRS[:3]]
    return [judge.score_binary(rows), judge.score_scale(rows),
            [mod.parse_binary(s) for s in ("x1", "0", "none")],
            [mod.parse_scale(s) for s in ("10", "3 of 10", "x")]]


def _annotations(mod):
    ann = mod.HeuristicRadGraphAnnotator()
    return [ann.annotate(PREDICTIONS), ann.annotate(REFERENCES)]


def _reward(comp, radgraph):
    hyp, ref = _annotations(radgraph)
    return [comp.radgraph_reward(h, r) for h, r in zip(hyp, ref)]


def _composite(mod, tmp):
    cols = {c: list(np.linspace(0.1, 0.9, len(PAIRS)) + i / 10)
            for i, c in enumerate(mod.RADCLIQ_COLUMNS)}
    out = [mod.radcliq_scores(cols), mod.fallback_composite(np.asarray(
        [cols[c] for c in mod.RADCLIQ_COLUMNS]).T).tolist()]
    if tmp is not None:
        out.append(mod.radcliq_scores(cols, checkpoint_dir=tmp))
    metric = mod.CompositeMetric(np.asarray([0.5, -1.0, 2.0, 0.25, 1.5]),
                                 np.asarray([0.1, 0.2, 0.3, 0.4]),
                                 np.asarray([1.5, 0.5, 2.0, 1.0]))
    out.append(metric.predict(np.asarray([cols[c] for c in mod.RADCLIQ_COLUMNS]).T).tolist())
    return out


def _as_plain(x):
    """Nested results with numpy arrays made lists (exact values kept)."""
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


CASES = {
    "tokenize": lambda m, *_: [m.metrics.tokenize(s) for s in PREDICTIONS + REFERENCES],
    "bleu1": lambda m, *_: _pairwise(m.metrics, "bleu", max_order=1),
    "bleu2": lambda m, *_: _pairwise(m.metrics, "bleu", max_order=2),
    "bleu4": lambda m, *_: _pairwise(m.metrics, "bleu"),
    "rouge1": lambda m, *_: _pairwise(m.metrics, "rouge_n", n=1),
    "rouge2": lambda m, *_: _pairwise(m.metrics, "rouge_n", n=2),
    "rougeL": lambda m, *_: _pairwise(m.metrics, "rouge_l"),
    "meteor": lambda m, *_: _pairwise(m.metrics, "meteor"),
    "exact_match": lambda m, *_: _pairwise(m.metrics, "exact_match"),
    "generic_rows": lambda m, *_: [m.GenericMetrics().compute(p, r) for p, r in PAIRS],
    "generic_all": lambda m, *_: m.GenericMetrics().compute_all(PREDICTIONS, REFERENCES),
    "chexpert_labels": lambda m, *_: [m.KeywordChexpertLabeler()(r)
                                      for r in PREDICTIONS + REFERENCES],
    "cxr_suite": lambda m, *_: m.CXRMetrics().compute(PREDICTIONS, REFERENCES),
    "ct_labels": lambda m, *_: [m.KeywordCTLabeler()(r) for r in PREDICTIONS + REFERENCES],
    "ct_suite": lambda m, *_: m.CTMetrics().compute(PREDICTIONS, references=REFERENCES),
    "judge": lambda m, *_: _judge(m.judge),
    "composite": lambda m, tmp: _composite(m.composite, tmp),
    "radgraph_annotations": lambda m, *_: _annotations(m.radgraph),
    "radgraph_reward": lambda m, *_: _reward(m.composite, m.radgraph),
    "radgraph_f1": lambda m, *_: m.radgraph.radgraph_f1(PREDICTIONS, REFERENCES),
}


class _Pkg:
    """A package's ``eval`` (its exports) with its submodules by name."""

    def __init__(self, root, metrics, judge, composite, radgraph):
        self.root, self.metrics, self.judge = root, metrics, judge
        self.composite, self.radgraph = composite, radgraph

    def __getattr__(self, name):
        return getattr(self.root, name)


PORT = _Pkg(peval, pmetrics, pjudge, pcomp, pradgraph)
JAX = _Pkg(jeval, jmetrics, jjudge, jcomp, jradgraph)


@pytest.fixture(scope="module")
def radcliq_dir(tmp_path_factory):
    from test_eval_models import _write_radcliq_pickles

    d = tmp_path_factory.mktemp("radcliq")
    _write_radcliq_pickles(d)
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case, radcliq_dir):
    got = _as_plain(CASES[case](PORT, radcliq_dir))
    want = _as_plain(CASES[case](JAX, radcliq_dir))
    assert got == want
    assert got not in ([], {}, None)


def test_exports_match():
    assert sorted(peval.__all__) == sorted(jeval.__all__)


# ---- eval/models.py on tiny BERT state dicts --------------------------------

@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """CheXbert and RadBERT checkpoints and a BERT of the tiny config, with
    its word tokenizer (``transformers`` is the scorers' own dependency)."""
    import transformers
    from test_eval_models import _tiny_bert_cfg, _tiny_bert_tokenizer

    tmp = tmp_path_factory.mktemp("bert")
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(**_tiny_bert_cfg()))
    state = {f"module.bert.{k}": v for k, v in model.state_dict().items()}
    for i in range(14):
        head = torch.nn.Linear(32, 2 if i == 13 else 4)
        state[f"module.linear_heads.{i}.weight"] = head.weight.data
        state[f"module.linear_heads.{i}.bias"] = head.bias.data
    torch.save({"model_state_dict": state}, tmp / "chexbert.pth")
    backbone = transformers.RobertaModel(transformers.RobertaConfig(**_tiny_bert_cfg()))
    rstate = {f"model.{k}": v for k, v in backbone.state_dict().items()}
    fc = torch.nn.Linear(32, 18)
    rstate["fc.weight"], rstate["fc.bias"] = fc.weight.data, fc.bias.data
    torch.save(rstate, tmp / "radbert.pth")
    return tmp, _tiny_bert_tokenizer(tmp), model


TEXTS = ["pleural effusion is seen .", "no cardiomegaly .", "effusion", ""]


def test_chexbert_labeler_matches_jax(bert):
    from mmmm_tpu.eval.models import ChexbertLabeler as JaxChexbert
    from mmmm_tpu_torch.eval.models import ChexbertLabeler

    tmp, tok, _ = bert
    port = ChexbertLabeler(tmp / "chexbert.pth", tokenizer=tok, device="cpu")
    ref = JaxChexbert(tmp / "chexbert.pth", tokenizer=tok)
    for t in TEXTS:
        np.testing.assert_array_equal(port(t), ref(t))
        np.testing.assert_array_equal(port.embed(t), ref.embed(t))
    assert port.similarity(*TEXTS[:2]) == ref.similarity(*TEXTS[:2])
    got = peval.CXRMetrics(labeler=port).compute(TEXTS, TEXTS[::-1])
    assert got == jeval.CXRMetrics(labeler=ref).compute(TEXTS, TEXTS[::-1])


def test_radbert_classifier_matches_jax(bert):
    from mmmm_tpu.eval.models import RadBertClassifier as JaxRadBert
    from mmmm_tpu_torch.eval.models import RadBertClassifier

    tmp, tok, _ = bert
    port = RadBertClassifier(tmp / "radbert.pth", tokenizer=tok, device="cpu")
    ref = JaxRadBert(tmp / "radbert.pth", tokenizer=tok)
    for t in TEXTS:
        labels = port(t)
        assert labels.shape == (18,)
        np.testing.assert_array_equal(labels, ref(t))


def test_bertscore_matches_jax(bert):
    from mmmm_tpu.eval.models import BERTScorer as JaxBERTScorer
    from mmmm_tpu_torch.eval.models import BERTScorer

    _, tok, model = bert
    port = BERTScorer(model=model, tokenizer=tok, device="cpu")
    ref = JaxBERTScorer(model=model, tokenizer=tok)
    for p in TEXTS:
        for r in TEXTS:
            assert port(p, r) == ref(p, r)
    assert port(TEXTS[0], TEXTS[0]) == pytest.approx(1.0, abs=1e-5)
