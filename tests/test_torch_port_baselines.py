"""The port's baseline harnesses (``mmmm_tpu_torch/eval/baselines.py``,
``mmmm_tpu_torch/train/baselines.py``, ``cli.py predict-baseline`` and
``finetune-baseline``) against the JAX package's ``scripts/evaluate/
baselines.py`` and ``scripts/finetune/baselines.py``.

They need outside checkpoints, so the harnesses themselves are held by their
registry and refusal paths; the finetune example builders and the training
loop run on the JAX tests' tiny locally built word tokenizer (a stand-in
processor where the HF processor classes would pull in TensorFlow), and
their tensors are compared exactly.
"""
import csv
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mmmm_tpu_torch import cli
from mmmm_tpu_torch.eval import baselines as ebase
from mmmm_tpu_torch.train import baselines as fbase
from test_finetune_baselines import _image, _word_tokenizer

ROOT = Path(__file__).resolve().parent.parent


def _script(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_EVAL = _script("scripts/evaluate/baselines.py", "jax_eval_baselines")
J_FT = _script("scripts/finetune/baselines.py", "jax_finetune_baselines")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny model (the suite runs six workers:
    torch's default pool made ``predict-baseline``'s 256-token decodes
    about 70x slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_and_refusals():
    """The same registry; an unknown name and the vendored architectures
    refuse as the JAX script's do, naming what is missing."""
    assert sorted(ebase.REGISTRY) == sorted(J_EVAL.REGISTRY)
    assert sorted(fbase.EXAMPLE_BUILDERS) == sorted(J_FT.EXAMPLE_BUILDERS)
    for mod in (J_EVAL, ebase):
        with pytest.raises(KeyError, match="unknown baseline 'nope'"):
            mod.build_baseline("nope", "ckpt")
        for name, package in (("radfm", "Model.RadFM"), ("r2gengpt", "r2gengpt")):
            with pytest.raises(ImportError, match=package):
                mod.build_baseline(name, "ckpt")
    with pytest.raises(ImportError, match="llava package"):
        fbase.load_finetune_model("llavamed", "ckpt", device="cpu")
    with pytest.raises(ImportError, match="llava package"):
        cli.main(["finetune-baseline", "--model", "llavamed", "--checkpoint", "ckpt",
                  "--dataset-dir", "data", "--out", "out", "--device", "cpu"])
    assert fbase.RG_PROMPT == J_FT.RG_PROMPT and fbase.CE_IGNORE_INDEX == J_FT.CE_IGNORE_INDEX


def test_baselines_default_to_the_card():
    """Without ``--device cpu`` every HF harness, the finetune loader and
    both commands run on CUDA; with no card they raise before loading."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("instructblip", "llavanext", "llavamed", "cogvlm", "m3d", "mmmm"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ebase.build_baseline(name, "ckpt")
    for name in ("instructblip", "llavanext", "cogvlm", "m3d", "llavamed"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fbase.load_finetune_model(name, "ckpt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["predict-baseline", "--model", "llavanext", "--checkpoint", "ckpt", "--task",
                  "vqa", "--dataset-dir", "data", "--output", "out.csv"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["finetune-baseline", "--model", "instructblip", "--checkpoint", "ckpt",
                  "--dataset-dir", "data", "--out", "out"])


class _Processor:
    """The HF processor call the InstructBLIP and LLaVA-NeXT builders make,
    over a tokenizer: ``input_ids``, ``attention_mask`` and a constant
    ``pixel_values``."""

    def __init__(self, tok):
        self.tokenizer = self.qformer_tokenizer = tok

    def __call__(self, images, text, return_tensors):
        out = self.tokenizer(text, return_tensors=return_tensors)
        out["pixel_values"] = torch.ones(1, 3, 4, 4)
        return out


def _shim(mod, extra=(), **kw):
    tok = _word_tokenizer()
    if extra:
        tok.add_tokens(list(extra), special_tokens=True)
    return mod.SimpleVLProcessor(tok, (32, 32), **kw)


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_example_builders_match_jax():
    """Every builder on the same tokenizer, image, question and answer:
    equal tensors; ``pack_qa_pairs`` over two pairs and a length cap."""
    pairs = [("tok3 tok4", "tok5 tok6"), ("tok7 ?", "tok8")]
    tok = _word_tokenizer()
    for max_len in (None, 9):
        ga = J_FT.pack_qa_pairs(tok, pairs, max_seq_len=max_len, first_prefix="tok2 ")
        gb = fbase.pack_qa_pairs(tok, pairs, max_seq_len=max_len, first_prefix="tok2 ")
        assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    image = _image()
    for name, extra, kw in (("cogvlm", (), dict(num_vision_tokens=7)),
                            ("llavamed", ("<image>",), {}),
                            ("m3d", ("<im_patch>",), dict(proj_out_num=5))):
        a = J_FT.EXAMPLE_BUILDERS[name](_shim(J_FT, extra, **kw), image, "tok3 ?", "tok5 tok6")
        b = fbase.EXAMPLE_BUILDERS[name](_shim(fbase, extra, **kw), image, "tok3 ?", "tok5 tok6")
        _same(a, b)
    for name in ("instructblip", "llavanext"):
        a = J_FT.EXAMPLE_BUILDERS[name](_Processor(_word_tokenizer()), image, "tok3 ?", "tok5")
        b = fbase.EXAMPLE_BUILDERS[name](_Processor(_word_tokenizer()), image, "tok3 ?", "tok5")
        _same(dict(a), dict(b))
        assert (b["labels"][0, :-1] == fbase.CE_IGNORE_INDEX).all()


def test_finetune_loop_and_items_match_jax(tmp_path):
    """The shared loop over a tiny model with the reference's signature,
    from one seed in each package: the same losses, the vision tower frozen;
    the VQA and report item iterators over one processed dataset."""
    items = [{"key": "a", "image": ["img.png"],
              "vqa": [{"question": "q1", "answer": "a1"}, {"question": "q2", "answer": "a2"}]},
             {"key": "b", "image": ["img2.png"], "processed_report": "All clear."},
             {"key": "c", "image": ["img3.png"], "findings": "Nodule in RUL."}]
    (tmp_path / "train.json").write_text(json.dumps(items))
    for fn in ("iter_vqa_items", "iter_report_items"):
        assert list(getattr(fbase, fn)(tmp_path)) == list(getattr(J_FT, fn)(tmp_path))

    def run(mod):
        proc = _shim(mod, ("<im_patch>",), proj_out_num=3)
        vocab = len(proc.tokenizer)

        class TinyRefModel(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.vision_tower = torch.nn.Linear(32 * 32, 8)
                self.embed = torch.nn.Embedding(vocab, 16)
                self.lm_head = torch.nn.Linear(16, vocab)

            def forward(self, input_ids, images, attention_mask, labels):
                logits = self.lm_head(self.embed(input_ids.clamp(min=0)))
                loss = torch.nn.functional.cross_entropy(
                    logits[:, :-1].flatten(0, 1), labels[:, 1:].flatten(),
                    ignore_index=mod.CE_IGNORE_INDEX)
                return type("O", (), {"loss": loss})()

        torch.manual_seed(0)
        model = TinyRefModel()
        losses = mod.finetune_torch_model(
            model, proc, [(_image(), "tok3 ?", "tok5 tok6")] * 3, mod.m3d_example, steps=8,
            lr=1e-2, grad_accum=2, log_every=2, freeze_pred="by_vision_substring")
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
        return losses, frozen

    ja, pa = run(J_FT), run(fbase)
    assert pa == ja and pa[1] == ["vision_tower.weight", "vision_tower.bias"]
    assert pa[0][-1] < pa[0][0]


def test_predict_baseline_command(tmp_path):
    """``predict-baseline --model mmmm`` at conf/tiny/fit.yaml on the CPU:
    the ``predict`` CSV contract (question, answer, prediction) over the
    VQA test items in order, each prediction the harness's own answer."""
    from PIL import Image

    data = tmp_path / "VQA"
    data.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 48), np.uint8)).save(
        data / "x.png")
    (data / "test.json").write_text(json.dumps([
        {"image": ["x.png"], "vqa": [{"question": "Is there a nodule?", "answer": "no"},
                                     {"question": "Which organ?", "answer": "lung"}]}]))
    conf = str(ROOT / "conf" / "tiny" / "fit.yaml")
    out = tmp_path / "pred.csv"
    cli.main(["predict-baseline", "--model", "mmmm", "--checkpoint", conf, "--task", "vqa",
              "--dataset-dir", str(data), "--output", str(out), "--device", "cpu"])
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [(r["question"], r["answer"]) for r in rows] == [("Is there a nodule?", "no"),
                                                           ("Which organ?", "lung")]
    predict = ebase.build_baseline("mmmm", conf, device="cpu", max_new_tokens=256)
    assert [r["prediction"] for r in rows] == [predict(str(data / "x.png"), r["question"])
                                               for r in rows]
    with pytest.raises(ImportError, match="Model.RadFM"):
        cli.main(["predict-baseline", "--model", "radfm", "--checkpoint", "c", "--task", "vqa",
                  "--dataset-dir", str(data), "--output", str(out)])
