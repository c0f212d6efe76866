"""The port's HF PEFT adapter interop (``train/peft_export.py``) against the
JAX package's: each package reads the adapter the other writes, bit for
bit, and the port's own safetensors reader and writer cross-read with the
``safetensors`` package (the JAX package writes through
``safetensors.numpy``); the ``adapter_model.bin`` fallback and the
``.lora_A.default.weight`` names load too."""
import json

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.train import peft_export as jpeft
from mmmm_tpu_torch.models.mmmm import MMMMConfig, MMMMModel
from mmmm_tpu_torch.peft import LoraConfig, lora_init
from mmmm_tpu_torch.train import peft_export as ppeft

CFG = MMMMConfig.tiny()
LAYERS = dict(num_layers=CFG.vlm.num_hidden_layers,
              num_vision_layers=CFG.vlm.vision.num_hidden_layers)


@pytest.fixture(scope="module")
def lora():
    """A LoRA tree of the tiny model (r 4, rsLoRA) with non-zero ``b``."""
    params = MMMMModel(CFG).init(0, device="cpu")
    tree = lora_init(torch.Generator().manual_seed(1), params,
                     LoraConfig(r=4, alpha=8, use_rslora=True))
    shift = lambda t: {k: shift(v) if isinstance(v, dict) else v + 0.01 for k, v in t.items()}
    return shift(tree)


def _flat(tree):
    return ppeft._flatten(tree)


def _assert_same(port_tree, other, prefix=""):
    ours = _flat(port_tree)
    theirs = ppeft._flatten(other)
    assert len(theirs) == len(ours) > 10
    for path, ab in theirs.items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(ab[k]), ours[path][k].numpy(),
                                          err_msg=f"{path}/{k}")


def test_port_export_reads_in_jax(lora, tmp_path):
    ppeft.export_peft_adapter(tmp_path / "ad", lora, LoraConfig(r=4, alpha=8, use_rslora=True))
    cfg = json.loads((tmp_path / "ad" / "adapter_config.json").read_text())
    assert cfg["peft_type"] == "LORA" and cfg["r"] == 4 and cfg["use_rslora"]
    back, jcfg = jpeft.import_peft_adapter(tmp_path / "ad", **LAYERS)
    assert (jcfg.r, jcfg.alpha, jcfg.use_rslora) == (4, 8, True)
    _assert_same(lora, back)


def test_jax_export_reads_in_port(lora, tmp_path):
    as_np = lambda t: {k: as_np(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}
    jpeft.export_peft_adapter(tmp_path / "ad", as_np(lora),
                              JaxLoraConfig(r=4, alpha=8, use_rslora=True))
    back, cfg = ppeft.import_peft_adapter(tmp_path / "ad", **LAYERS)
    assert (cfg.r, cfg.alpha, cfg.use_rslora) == (4, 8, True)
    _assert_same(lora, back)
    # the same files as the port writes, byte for byte after decoding
    ppeft.export_peft_adapter(tmp_path / "port", lora, LoraConfig(r=4, alpha=8, use_rslora=True))
    a = np_load_file(str(tmp_path / "ad" / "adapter_model.safetensors"))
    b = np_load_file(str(tmp_path / "port" / "adapter_model.safetensors"))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert (json.loads((tmp_path / "ad" / "adapter_config.json").read_text())
            == json.loads((tmp_path / "port" / "adapter_config.json").read_text()))


def test_port_round_trip(lora, tmp_path):
    ppeft.export_peft_adapter(tmp_path / "ad", lora, LoraConfig(r=4, alpha=8, use_rslora=True))
    back, cfg = ppeft.import_peft_adapter(tmp_path / "ad", **LAYERS)
    assert cfg == LoraConfig(r=4, alpha=8, dropout=0.05, use_rslora=True)
    _assert_same(lora, {k: {"a": v["a"].numpy(), "b": v["b"].numpy()}
                        for k, v in _flat(back).items()})


def _tensors(rng):
    return {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f64": torch.from_numpy(rng.normal(size=(7,))),
        "f16": torch.from_numpy(rng.normal(size=(2, 3, 2)).astype(np.float16)),
        "bf16": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
        "i64": torch.arange(5) - 2,
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([[0, 255]], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
    }


def test_codec_reads_the_package(tmp_path):
    """``load_safetensors`` reads what ``safetensors.torch`` and
    ``safetensors.numpy`` write."""
    src = _tensors(np.random.default_rng(0))
    torch_save_file(src, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    got = ppeft.load_safetensors(tmp_path / "t.safetensors")
    assert got.keys() == src.keys()
    for k, t in src.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    np_src = {k: t.numpy() for k, t in src.items() if t.dtype != torch.bfloat16}
    np_save_file(np_src, str(tmp_path / "n.safetensors"))
    got = ppeft.load_safetensors(tmp_path / "n.safetensors")
    for k, a in np_src.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)


def test_package_reads_the_codec(tmp_path):
    """``safetensors.torch`` and ``safetensors.numpy`` read what
    ``save_safetensors`` writes, offsets aligned to each element."""
    src = _tensors(np.random.default_rng(1))
    ppeft.save_safetensors(tmp_path / "p.safetensors", src, {"format": "pt"})
    got = torch_load_file(str(tmp_path / "p.safetensors"))
    assert got.keys() == src.keys()
    for k, t in src.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    got = np_load_file(str(tmp_path / "p.safetensors"))
    for k, t in src.items():
        if t.dtype != torch.bfloat16:
            np.testing.assert_array_equal(got[k], t.numpy(), err_msg=k)
    raw = (tmp_path / "p.safetensors").read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    assert n % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    for k, h in header.items():
        if k != "__metadata__":
            assert h["data_offsets"][0] % src[k].element_size() == 0, k


def test_bin_fallback_and_default_names(lora, tmp_path):
    """Without ``adapter_model.safetensors`` the ``.bin`` is read, and PEFT's
    ``.lora_A.default.weight`` names map like ``.lora_A.weight``."""
    ppeft.export_peft_adapter(tmp_path / "ad", lora, LoraConfig(r=4, alpha=8, use_rslora=True))
    st = tmp_path / "ad" / "adapter_model.safetensors"
    tensors = ppeft.load_safetensors(st)
    renamed = {k.replace(".weight", ".default.weight") if i % 2 else k: v.clone()
               for i, (k, v) in enumerate(sorted(tensors.items()))}
    torch.save(renamed, tmp_path / "ad" / "adapter_model.bin")
    st.unlink()
    back, _ = ppeft.import_peft_adapter(tmp_path / "ad", **LAYERS)
    _assert_same(lora, {k: {"a": v["a"].numpy(), "b": v["b"].numpy()}
                        for k, v in _flat(back).items()})
    jback, _ = jpeft.import_peft_adapter(tmp_path / "ad", **LAYERS)
    _assert_same(lora, jback)
