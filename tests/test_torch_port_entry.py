"""The port's inference entry points against the JAX package's scripts:
``data/infer_transform.py image_transform`` against the JAX transform, and
the ``demo``, ``predict`` and ``evaluate`` commands of
``python -m mmmm_tpu_torch.cli`` against ``scripts/demo.py`` and
``scripts/evaluate/cli.py`` at ``conf/tiny/fit.yaml`` on the CPU.

The JAX scripts run as they are. The port's loader (``cli.load_model``) is
the one thing patched: it takes the tree of the JAX package's
``load_model_with_adapter`` (``model.init`` of ``PRNGKey(0)`` with the
same adapter merged) through ``params_from_jax``,
so both packages decode from the same weights. A recording wrapper around
the JAX ``generate_grounded`` keeps its tokens for the comparison; it
changes nothing the script does. The adapter (random finetuned leaves and
LoRA factors, written by the JAX ``save_adapter``) moves the random tiny
model off its first-step EOS, so the texts are not empty.
"""
import contextlib
import csv
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mmmm_tpu import build as jbuild
from mmmm_tpu.data.infer_transform import image_transform as jax_image_transform
from mmmm_tpu.data.local import DatasetConf as JaxDatasetConf
from mmmm_tpu.data.local import LocalTransConf as JaxLocalTransConf
from mmmm_tpu.models import inference as jinference
from mmmm_tpu.train import checkpoint as jckpt
from mmmm_tpu_torch import build as pbuild
from mmmm_tpu_torch import cli as pcli
from mmmm_tpu_torch.config import load_yaml
from mmmm_tpu_torch.data.infer_transform import image_transform
from mmmm_tpu_torch.data.local import DatasetConf, LocalTransConf
from mmmm_tpu_torch.models.mmmm import MMMMModel
from mmmm_tpu_torch.params import _flatten, _unflatten, params_from_jax
from mmmm_tpu_torch.peft import default_lora_targets, split_trainable

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"
NEW = 6


def _load_script(name: str, rel: str):
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))  # scripts/evaluate/cli.py imports demo
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _conf(pkg):
    local, dconf = ((LocalTransConf, DatasetConf) if pkg == "port"
                    else (JaxLocalTransConf, JaxDatasetConf))
    return dconf(base_vit_patch_size_z=4, vit_patch_size_xy=4, pool_size_xy=1,
                 base_pool_size_z=1, local_trans=local(max_vision_tokens=64, max_tokens_z=4))


@pytest.mark.parametrize("source", ["array_2d", "array_3d", "png", "pt"])
def test_image_transform_matches_jax(tmp_path, source):
    """Both images within 1e-6, the same patch, pool and token count."""
    rng = np.random.default_rng(0)
    if source == "array_2d":
        img = rng.integers(0, 255, size=(1, 1, 100, 80), dtype=np.uint8)
    elif source == "array_3d":
        img = rng.integers(0, 255, size=(1, 24, 64, 64), dtype=np.uint8)
    elif source == "png":
        img = tmp_path / "x.png"
        Image.fromarray(rng.integers(0, 255, size=(50, 70, 3), dtype=np.uint8), "RGB").save(img)
        img = str(img)
    else:
        img = tmp_path / "x.pt"
        torch.save(torch.from_numpy(rng.integers(0, 255, size=(1, 20, 40, 56),
                                                 dtype=np.uint8)), img)
        img = str(img)
    got = image_transform(img, _conf("port"))
    want = jax_image_transform(img, _conf("jax"))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    assert tuple(got[2]) == tuple(want[2]) and tuple(got[3]) == tuple(want[3])
    assert got[4] == want[4]


def _write_adapter(path: Path) -> None:
    """Random finetuned leaves and LoRA factors (r of the config) at the tiny
    config's shapes, in the JAX package's adapter file."""
    doc = load_yaml(TINY)
    r = doc["lora"]["r"]
    tok = pbuild.build_tokenizer(doc.get("tokenizer"))
    params = MMMMModel(pbuild.build_model(doc.get("model"), tok).cfg).init(0, device="cpu")
    base = _flatten(params)
    rng = np.random.default_rng(1)
    ft, _ = split_trainable(params)
    ft = {k: (rng.normal(size=t.shape) * 0.02).astype(np.float32)
          for k, t in _flatten(ft).items()}
    lora = {}
    for t in default_lora_targets(params):
        *lead, fan_in, fan_out = base[t].shape
        lora[f"{t}/a"] = rng.normal(size=(*lead, fan_in, r)).astype(np.float32)
        lora[f"{t}/b"] = (rng.normal(size=(*lead, r, fan_out)) * 0.1).astype(np.float32)
    jckpt.save_adapter(path, {"lora": _unflatten(lora), "ft": _unflatten(ft)})


def _dataset(root: Path) -> Path:
    """A VQA test set of two same-size images (a PNG and a ``.pt``), three
    questions."""
    ds = root / "VQA-demo"
    ds.mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, size=(48, 48), dtype=np.uint8), "L").save(ds / "a.png")
    torch.save(torch.from_numpy(rng.integers(0, 255, size=(1, 1, 48, 48), dtype=np.uint8)),
               ds / "b.pt")
    (ds / "test.json").write_text(json.dumps([
        {"key": "0", "image": ["a.png"],
         "vqa": [{"question": "Is the heart normal?", "answer": "yes"},
                 {"question": "Any effusion?", "answer": "no"}]},
        {"key": "1", "image": ["b.pt"],
         "vqa": [{"question": "Where is the nodule?", "answer": "left lung"}]},
    ]))
    return ds


def _run(fn, argv, stdin: str = "") -> str:
    out = io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            fn(argv)
    finally:
        sys.stdin = old
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command of both packages, once: the demo (grounded, two
    interactive turns), predict batched and continuous, evaluate."""
    tmp = tmp_path_factory.mktemp("entry")
    adapter = tmp / "adapter.npz"
    _write_adapter(adapter)
    ds = _dataset(tmp)
    demo = _load_script("jax_demo", "scripts/demo.py")
    ecli = _load_script("jax_eval_cli", "scripts/evaluate/cli.py")

    jax_tokens = []
    real = jinference.generate_grounded

    def spy(*a, **kw):
        res = real(*a, **kw)
        jax_tokens.append(np.asarray(res.tokens))
        return res

    def port_loader(config, adapter_path, quantize=False, device="cuda"):
        jmodel, jparams, _, doc = jbuild.load_model_with_adapter(config, adapter_path, quantize)
        tok = pbuild.build_tokenizer(doc.get("tokenizer"))
        model = pbuild.build_model(doc.get("model"), tok)
        return model, params_from_jax(jparams, device, cfg=model.cfg), tok, doc

    out = {"jax_tokens": jax_tokens}
    patch = pytest.MonkeyPatch()
    try:
        patch.setattr(jinference, "generate_grounded", spy)
        patch.setattr(pcli, "load_model", port_loader)
        demo_args = ["-c", str(TINY), "--adapter", str(adapter), "--max-new-tokens", str(NEW),
                     "--interactive"]
        stdin = "Is there a nodule?\n\n"
        out["jax_demo"] = _run(demo.main, demo_args, stdin)
        port_results = []
        real_cmd = pcli.cmd_demo
        patch.setattr(pcli, "cmd_demo", lambda args: port_results.extend(real_cmd(args)))
        out["port_demo"] = _run(pcli.main, ["demo", *demo_args, "--device", "cpu"], stdin)
        out["port_demo_tokens"] = [r.tokens for r in port_results]
        out["jax_demo_calls"] = len(jax_tokens)

        pred = ["-c", str(TINY), "--adapter", str(adapter), "--task", "vqa", "--dataset-dir",
                str(ds), "--max-new-tokens", str(NEW)]
        for label, extra in (("batched", ["--batch", "2"]),
                             ("continuous", ["--continuous", "--batch", "2"])):
            for pkg, fn, dev in (("jax", ecli.main, []), ("port", pcli.main, ["--device", "cpu"])):
                csv_path = tmp / f"{pkg}_{label}.csv"
                _run(fn, ["predict", *pred, *extra, "--output", str(csv_path), *dev])
                out[f"{pkg}_{label}"] = list(csv.DictReader(csv_path.open()))

        for pkg, fn, dev in (("jax", ecli.main, []), ("port", pcli.main, ["--device", "cpu"])):
            js, per_row = tmp / f"{pkg}_metrics.json", tmp / f"{pkg}_rows.csv"
            _run(fn, ["evaluate", "--input", str(tmp / "jax_batched.csv"), "--suite", "all",
                      "--output", str(js), "--per-row-output", str(per_row), *dev])
            out[f"{pkg}_eval"] = json.loads(js.read_text())
            out[f"{pkg}_eval_rows"] = per_row.read_text()
            ct = tmp / f"{pkg}_ct.json"
            _run(fn, ["evaluate", "--input", str(tmp / "jax_batched.csv"), "--suite", "ct",
                      "--output", str(ct), *dev])
            out[f"{pkg}_eval_ct"] = json.loads(ct.read_text())
    finally:
        patch.undo()
    return out


def test_demo_matches_jax_script(runs):
    """The same printed report, targets and follow-up turn, and the same
    tokens in each turn."""
    assert runs["port_demo"] == runs["jax_demo"]
    assert "=== generated ===" in runs["port_demo"]
    assert runs["port_demo"].count("=== generated ===") == 2  # the interactive turn
    jax = runs["jax_tokens"][: runs["jax_demo_calls"]]
    assert len(runs["port_demo_tokens"]) == len(jax) == 2
    for got, want in zip(runs["port_demo_tokens"], jax):
        np.testing.assert_array_equal(got, want)
    assert any((t != 2).any() for t in jax)  # not EOS at once


@pytest.mark.parametrize("mode", ["batched", "continuous"])
def test_predict_matches_jax_script(runs, mode):
    """The same CSV rows, token for token, batched and through the server."""
    port, jax = runs[f"port_{mode}"], runs[f"jax_{mode}"]
    assert len(port) == 3 and port == jax
    assert [r["answer"] for r in port] == ["yes", "no", "left lung"]


def test_predict_paths_agree(runs):
    """Batched and continuous give the same predictions (as
    ``tests/test_evaluate_cli.py`` requires of the JAX script)."""
    preds = lambda rows: [r["prediction"] for r in rows]
    assert preds(runs["port_batched"]) == preds(runs["port_continuous"])


@pytest.mark.parametrize("suite", ["all", "ct"])
def test_evaluate_matches_jax_script(runs, suite):
    """The summary JSON equal to the JAX script's (and its per-row CSV)."""
    key = "eval" if suite == "all" else "eval_ct"
    assert runs[f"port_{key}"] == runs[f"jax_{key}"]
    if suite == "all":
        assert runs["port_eval_rows"] == runs["jax_eval_rows"]
        assert runs["port_eval"]["radgraph_annotator"] == "heuristic"
        assert "bleu1" in runs["port_eval"] and "chexpert_micro_f1_14" in runs["port_eval"]


def test_tp_above_one_names_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 8b"):
        pcli.main(["demo", "-c", str(TINY), "--tp", "2", "--device", "cpu"])


def _tag_chain(params, tok) -> None:
    """Point ``lm_head``'s columns so that the random tiny model, whose final
    hidden state is near its input token's embedding, writes the cycle
    ``x <p> y </p> x ...``: each next token's column is its predecessor's
    embedding, normalized."""
    emb, head = params["cogvlm"]["llm"]["embed_tokens"], params["cogvlm"]["llm"]["lm_head"]
    x, y = 3 + ord("a"), 3 + ord("b")
    for prev, nxt in ((x, tok.bop_token_id), (tok.bop_token_id, y), (y, tok.eop_token_id),
                      (tok.eop_token_id, x)):
        head[:, nxt] = emb[prev] / emb[prev].norm()


@pytest.mark.parametrize("instance", [False, True])
def test_demo_prints_its_grounded_targets(instance):
    """With ``lm_head`` pointed to write tag pairs, the demo grounds its
    targets: its tokens are those of a direct ``generate_grounded`` call on
    the same inputs, and it prints each target's mask voxels (semantic SAM)
    or best box (instance SAM) from that call's outputs."""
    from mmmm_tpu_torch.data import ConvTurn
    from mmmm_tpu_torch.data.input_builder import prepare_vlm_inputs
    from mmmm_tpu_torch.models.inference import generate_grounded

    model, params, tok, doc = pbuild.load_model_with_adapter(str(TINY), None, device="cpu")
    _tag_chain(params, tok)
    argv = ["demo", "-c", str(TINY), "--max-new-tokens", "12", "--device", "cpu"]
    args = pcli.parse_args(argv + (["--instance"] if instance else []))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        (res,) = pcli.cmd_demo(args, loaded=(model, params, tok, doc))
    image, gimg, patch, pool, n = pcli.prepare_image(None, pcli._data_conf(doc))
    inputs, _ = prepare_vlm_inputs([ConvTurn(args.question, "")], tok, n, inference=True,
                                   grounding=True)
    want = generate_grounded(
        params, model.cfg, tok, np.asarray(inputs.input_ids)[None],
        np.asarray(inputs.token_type_ids)[None], np.asarray(inputs.position_ids)[None],
        np.asarray([len(inputs.input_ids)]), image[None], patch, pool, max_new_tokens=12,
        grounding_image=gimg[None], instance=instance, device="cpu")
    np.testing.assert_array_equal(res.tokens, want.tokens)
    n_valid = int(want.target_valid[0].sum())
    assert n_valid >= 1
    lines = [l for l in out.getvalue().splitlines() if l.startswith("target ")]
    assert len(lines) == n_valid
    if instance:
        disc = torch.sigmoid(want.disc_logit[0])
        best = [int(disc[i].argmax()) for i in range(n_valid)]
        assert all(f"p={disc[i, b]:.3f}" in lines[i] for i, b in enumerate(best))
    else:
        vox = [int((torch.sigmoid(want.masks[0, i]) > 0.5).sum()) for i in range(n_valid)]
        assert lines == [f"target {i}: mask voxels>0.5 = {v}" for i, v in enumerate(vox)]


def test_chip_smoke_entry_config_mirrors_the_yaml():
    """chip_smoke.py's phase 8 loads the flagship from a dict (the card has
    no PyYAML): ``PHASE_VLM_FIT`` is conf/phase-vlm/fit.yaml's model,
    tokenizer, LoRA and data ``conf`` as ``load_yaml`` resolves them."""
    import chip_smoke

    fit = load_yaml(ROOT / "conf" / "phase-vlm" / "fit.yaml")
    cfg = chip_smoke.PHASE_VLM_FIT
    assert cfg["model"] == fit["model"] == load_yaml(ROOT / "conf" / "model.yaml")
    assert cfg["tokenizer"] == fit["tokenizer"] and cfg["lora"] == fit["lora"]
    assert cfg["data"] == {"conf": fit["data"]["conf"]}
