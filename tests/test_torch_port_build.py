"""The port's host modules against the JAX package's: the HuggingFace
tokenizer backend (``data/tokenizer.py``), the YAML config system
(``config.py``), the ``.npz`` checkpoints (``train/checkpoint.py``) and the
builders (``build.py``), on ``conf/tiny/fit.yaml`` and files written in a
temporary directory. Each package reads the files the other writes.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mmmm_tpu import build as jbuild
from mmmm_tpu import config as jconfig
from mmmm_tpu.data import tokenizer as jtokenizer
from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.peft import lora_merge as jax_lora_merge
from mmmm_tpu.train import checkpoint as jckpt
from mmmm_tpu_torch import build as pbuild
from mmmm_tpu_torch import config as pconfig
from mmmm_tpu_torch.data import tokenizer as ptokenizer
from mmmm_tpu_torch.models.mmmm import MMMMModel
from mmmm_tpu_torch.params import _flatten, _unflatten
from mmmm_tpu_torch.peft import default_lora_targets, split_trainable
from mmmm_tpu_torch.train import checkpoint as pckpt

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"
WORDS = "the heart is normal lungs are clear a nodule seen no effusion"


def _hf_tokenizer():
    """tests/test_tokenizer_hf.py's word-level fast tokenizer, made in memory."""
    try:
        from tokenizers import Tokenizer
        from tokenizers.models import WordLevel
        from tokenizers.pre_tokenizers import Whitespace
        from transformers import PreTrainedTokenizerFast
    except ImportError:
        pytest.skip("tokenizers/transformers unavailable")
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({w: i for i, w in enumerate(WORDS.split(), start=4)})
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", bos_token="<s>",
                                  eos_token="</s>", unk_token="<unk>")


def test_hf_backend_wraps_and_grounds():
    """The HF backend splits on the grounding specials natively and gives the
    JAX package's ids, texts and parsed targets."""
    hf = _hf_tokenizer()
    hf.add_tokens(list(ptokenizer.SPECIAL_TOKENS), special_tokens=True)
    special = {t: hf.convert_tokens_to_ids(t) for t in ptokenizer.SPECIAL_TOKENS}
    mt = ptokenizer.MMMMTokenizer(ptokenizer._HFBackend(hf), special)
    jt = jtokenizer.MMMMTokenizer(jtokenizer._HFBackend(hf), special)
    text = "the heart is <p> normal</p> no effusion"
    ids = mt.encode(text)
    assert mt.bop_token_id in ids and mt.eop_token_id in ids
    assert ids == jt.encode(text)
    assert mt.decode(ids) == jt.decode(ids)
    [targets] = mt.parse_targets(np.asarray([ids]))
    assert targets == ["normal"] == jt.parse_targets(np.asarray([ids]))[0]
    assert (mt.bos_token_id, mt.eos_token_id, mt.pad_token_id, len(mt)) == \
        (jt.bos_token_id, jt.eos_token_id, jt.pad_token_id, len(jt))


def test_from_pretrained_and_build_tokenizer(tmp_path):
    """A tokenizer directory loads as the JAX package loads it, through
    ``from_pretrained`` and ``build_tokenizer``; no path gives the byte
    tokenizer."""
    _hf_tokenizer().save_pretrained(tmp_path)
    mt = pbuild.build_tokenizer({"path": str(tmp_path)})
    jt = jtokenizer.MMMMTokenizer.from_pretrained(str(tmp_path))
    assert isinstance(mt.backend, ptokenizer._HFBackend)
    text = "a nodule seen <p> lungs</p> <np>heart</np>"
    assert mt.encode(text) == jt.encode(text)
    assert (mt.bop_token_id, mt.eop_token_id) == (jt.bop_token_id, jt.eop_token_id)
    assert isinstance(pbuild.build_tokenizer({"path": None}).backend, ptokenizer._ByteBackend)


def test_load_yaml_and_build_match_jax():
    """``conf/tiny/fit.yaml``: the same document (``${}`` resolved) and the
    same model and LoRA configs, field for field."""
    from mmmm_tpu.models import MMMMConfig as JaxConfig
    from mmmm_tpu_torch.models.mmmm import MMMMConfig
    from mmmm_tpu_torch.peft import LoraConfig

    doc = pconfig.load_yaml(TINY)
    assert doc == jconfig.load_yaml(TINY)
    assert doc["optimizer"]["max_steps"] == doc["trainer"]["max_steps"] == 4
    assert pconfig.load_yaml(TINY, resolve=False) == jconfig.load_yaml(TINY, resolve=False)
    got, ref = pconfig.build(MMMMConfig, doc["model"]), jconfig.build(JaxConfig, doc["model"])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.vlm.vision.patch_size == (4, 4, 4)
    assert dataclasses.asdict(pconfig.build(LoraConfig, doc["lora"])) == \
        dataclasses.asdict(jconfig.build(JaxLoraConfig, doc["lora"]))
    with pytest.raises(KeyError, match="unknown config key"):
        pconfig.build(LoraConfig, {"rank": 4})
    for ov in (["trainer.max_steps=7", "lora.r=8"], ["new.key=[1, 2]"]):
        assert pconfig.apply_overrides(pconfig.load_yaml(TINY), ov) == \
            jconfig.apply_overrides(jconfig.load_yaml(TINY), ov)


def test_load_yaml_includes(tmp_path):
    """``_include`` bases merged first, a ``.yaml`` value loaded in place,
    ``${}`` interpolated from the root, as the JAX package does."""
    (tmp_path / "base.yaml").write_text("a: {x: 1, y: 2}\nsteps: 5\n")
    (tmp_path / "data.yaml").write_text("batch: ${steps}\nname: d\n")
    (tmp_path / "run.yaml").write_text(
        "_include: base.yaml\na: {y: 3}\ndata: data.yaml\nz: ${a.y}\nlist: ['${steps}', b]\n")
    doc = pconfig.load_yaml(tmp_path / "run.yaml")
    assert doc == jconfig.load_yaml(tmp_path / "run.yaml")
    assert doc == {"a": {"x": 1, "y": 3}, "steps": 5, "data": {"batch": 5, "name": "d"},
                   "z": 3, "list": [5, "b"]}


def _tree():
    rng = np.random.default_rng(0)
    return {"lora": {"w": {"a": rng.normal(size=(2, 3)).astype(np.float32),
                           "b": rng.normal(size=(3, 4)).astype(np.float32)}},
            "ft": {"emb": rng.integers(-5, 5, size=(4,)).astype(np.int32),
                   "bf": rng.normal(size=(2, 2)).astype(ml_dtypes.bfloat16)}}


def _bits(x):
    """A leaf's dtype-free bytes, for either package's bf16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().tobytes() if x.dtype == torch.bfloat16 else \
            x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_adapter_files_cross_read(tmp_path):
    """An adapter the JAX package wrote loads in the port (bf16 leaves as
    bf16 tensors) and the port's file loads in the JAX package, bit for bit."""
    tree = _tree()
    jckpt.save_adapter(tmp_path / "jax.npz", tree)
    got = _flatten(pckpt.load_adapter(tmp_path / "jax.npz"))
    ref = _flatten(tree)
    assert got.keys() == ref.keys()
    assert got["ft/bf"].dtype == torch.bfloat16
    for k in ref:
        assert _bits(got[k]) == _bits(ref[k]), k
    pckpt.save_adapter(tmp_path / "port.npz", _unflatten(got))
    back = _flatten(jckpt.load_adapter(tmp_path / "port.npz"))
    assert back.keys() == ref.keys()
    for k in ref:
        assert _bits(back[k]) == _bits(ref[k]), k


def test_params_files_cross_read(tmp_path):
    """``save_params`` trees with lists and a JSON leaf, read by the other
    package: the same structure and bits as the writer's own reader gives
    (a JSON leaf's name loses its NUL marker in the zip, so both read back
    its uint8 bytes)."""
    tree = {"cogvlm": _tree(), "layers": [np.arange(3, dtype=np.float32),
                                          {"k": np.ones(2, np.int8)}], "meta": {"step": 7}}
    jckpt.save_params(tmp_path / "jax", tree)
    ref = _flatten({**jckpt.load_params(tmp_path / "jax"), "layers": {}})
    got = pckpt.load_params(tmp_path / "jax")
    assert isinstance(got["layers"], list) and len(got["layers"]) == 2
    np.testing.assert_array_equal(got["layers"][0].numpy(), tree["layers"][0])
    assert _bits(got["layers"][1]["k"]) == np.ones(2, np.int8).tobytes()
    assert _bits(got["meta"]["step"]) == _bits(ref["meta/step"]) == b"7"
    assert _bits(got["cogvlm"]["ft"]["bf"]) == _bits(tree["cogvlm"]["ft"]["bf"])
    pckpt.save_params(tmp_path / "port.npz", got)
    back = jckpt.load_params(tmp_path / "port.npz")
    np.testing.assert_array_equal(back["layers"][0], tree["layers"][0])
    np.testing.assert_array_equal(back["meta"]["step"], ref["meta/step"])
    assert _bits(back["cogvlm"]["ft"]["bf"]) == _bits(tree["cogvlm"]["ft"]["bf"])


def test_load_model_with_adapter_from_jax_adapter(tmp_path):
    """``conf/tiny/fit.yaml`` with an adapter the JAX package wrote: the
    model config of the JAX builder, the adapter's finetuned leaves, and for
    every targeted weight the LoRA delta (merged minus base) of the JAX
    package's ``lora_merge``; ``quantize=True`` gives W8A16 leaves. The base
    weights are the port's seeded init (the packages' generators differ)."""
    model, params, tok, doc = pbuild.load_model_with_adapter(str(TINY), None, device="cpu")
    jtok = jbuild.build_tokenizer(doc.get("tokenizer"))
    jmodel = jbuild.build_model(doc.get("model"), jtok)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
    base = _flatten(params)
    assert all(torch.equal(base[k], t) for k, t in _flatten(MMMMModel(model.cfg).init(
        0, device="cpu")).items())

    rng = np.random.default_rng(1)
    ft, _ = split_trainable(params)
    ft = {k: rng.normal(size=t.shape).astype(np.float32) for k, t in _flatten(ft).items()}
    r = doc["lora"]["r"]
    targets = default_lora_targets(params)
    lora = {}
    for t in targets:
        *lead, fan_in, fan_out = base[t].shape
        lora[f"{t}/a"] = rng.normal(size=(*lead, fan_in, r)).astype(np.float32)
        lora[f"{t}/b"] = rng.normal(size=(*lead, r, fan_out)).astype(np.float32) * 0.1
    jckpt.save_adapter(tmp_path / "adapter.npz",
                       {"lora": _unflatten(lora), "ft": _unflatten(ft)})
    _, merged, _, _ = pbuild.load_model_with_adapter(str(TINY), str(tmp_path / "adapter.npz"),
                                                     device="cpu")
    merged = _flatten(merged)
    assert merged.keys() == base.keys()
    for k, v in ft.items():
        np.testing.assert_array_equal(merged[k].numpy(), v)
    zeros = _unflatten({t: jnp.zeros(base[t].shape, jnp.float32) for t in targets})
    jlora = _unflatten({k: jnp.asarray(v) for k, v in lora.items()})
    delta = _flatten(jax_lora_merge(zeros, jlora, jconfig.build(JaxLoraConfig, doc["lora"])))
    for t in targets:
        np.testing.assert_allclose((merged[t] - base[t]).numpy(), np.asarray(delta[t]),
                                   rtol=1e-5, atol=1e-6, err_msg=t)
    untouched = set(base) - set(targets) - set(ft)
    assert untouched and all(torch.equal(merged[k], base[k]) for k in untouched)

    _, qparams, _, _ = pbuild.load_model_with_adapter(str(TINY), str(tmp_path / "adapter.npz"),
                                                      quantize=True, device="cpu")
    assert set(qparams["cogvlm"]["llm"]["lm_head"]) == {"q", "s"}
    assert qparams["cogvlm"]["llm"]["lm_head"]["q"].dtype == torch.int8
