"""The port's data-preparation commands (``mmmm_tpu_torch/preprocess/
{clean_reports,tag_reports,self_label,compress_vl,convert_vl}.py`` and their
``cli.py`` commands) against the JAX package's ``scripts/data/*.py`` on the
same seeded inputs, each package writing into a directory of its own.

Written JSON and CSV files are compared byte for byte (after the output
directory's own path, where a file names it), arrays exactly. The prompts
are the JAX script's byte for byte. The LLM route runs both packages'
``make_text_generator`` at a tiny CogVLM (one seeded numpy tree, bridged
with ``params_from_jax``): the same texts, static and continuous. The SAM
pseudo-labels at a tiny ``SamConfig``: probabilities within 1e-5, masks
equal wherever the probability is more than 1e-5 from the threshold.
"""
import csv
import dataclasses
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.data.tokenizer import MMMMTokenizer as JaxTokenizer
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import llm_batch as jbatch
from mmmm_tpu.utils import load_pt_zst as jax_load_pt_zst
from mmmm_tpu.utils import save_pt_zst as jax_save_pt_zst
from mmmm_tpu_torch import MMMMConfig, cli, params_from_jax
from mmmm_tpu_torch.data.target_tax import get_target_tax
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.models.llm_batch import make_text_generator
from mmmm_tpu_torch.preprocess import clean_reports, compress_vl, convert_vl, self_label
from mmmm_tpu_torch.preprocess.tag_reports import tag_dataset
from mmmm_tpu_torch.utils import load_pt_zst, save_pt_zst
from test_torch_port_models import numpy_params

ROOT = Path(__file__).resolve().parent.parent


def _script(rel: str, name: str):
    """A JAX script loaded under a name of its own (two of them are called
    ``baselines``, and other test files import these by their bare names)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_CLEAN = _script("scripts/data/clean_reports.py", "jax_clean_reports")
J_TAG = _script("scripts/data/tag_reports.py", "jax_tag_reports")
J_COMPRESS = _script("scripts/data/compress_vl.py", "jax_compress_vl")
J_CONVERT = _script("scripts/data/convert_vl.py", "jax_convert_vl")
J_SELF_LABEL = _script("scripts/data/self_label.py", "jax_self_label")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny tensors (the suite runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_files(a: Path, b: Path) -> int:
    """Every file under ``a`` and ``b`` equal byte for byte (``a``'s path
    read as ``b``'s inside JSON and CSV files; ``.pt.zst`` files as their
    arrays); returns the number of files."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        if rel.name.endswith(".pt.zst"):
            x, y = jax_load_pt_zst(a / rel), jax_load_pt_zst(b / rel)
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
            continue
        da, db = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.suffix in (".json", ".csv"):
            da = da.replace(str(a).encode(), str(b).encode())
        assert da == db, rel
    return len(fa)


# ---- clean-reports ----

REPORTS = [
    {"key": "a", "findings": "Lungs are clear. Heart size is stable compared to the prior exam.",
     "impression": "No acute process."},
    {"key": "b", "findings": "There is a new nodule in the right upper lobe.",
     "impression": "Pulmonary nodule, patient history of smoking."},
    {"key": "c", "findings": "Portable AP view. Mild edema unchanged.", "impression": ""},
    {"key": "d", "report": "CT of a 26-year-old. XXXX effusion."},
]
CAPTIONS = [{"key": "r1", "caption": "CT of a 26-year-old (Figure 2, arrow)."},
            {"key": "r2", "caption": "Axial MRI shows a lesion; see case 4."}]


def _stub(prompts):
    """A deterministic generator: the prompt's payload, reversed by words."""
    return [" ".join(p.split("Input: ", 1)[1].split()[:12][::-1]) + " " for p in prompts]


def test_prompts_are_the_scripts_byte_for_byte():
    for name in ("MIMIC_PASS1", "MIMIC_PASS2", "CT_RATE_PROMPT", "OPENI_PROMPT", "ROCO_PROMPT",
                 "CT_RATE_TRIGGERS"):
        assert getattr(clean_reports, name) == getattr(J_CLEAN, name), name


@pytest.mark.parametrize("dataset", ["MIMIC-CXR", "CT-RATE", "OpenI", "ROCOv2", "rule-based"])
def test_clean_dataset_matches_jax(tmp_path, dataset):
    """The same stub (or the rule-based cleaner) through both packages'
    ``clean_dataset``: the same prompts and the same ``-processed.json`` and
    ``.csv`` bytes."""
    items = CAPTIONS if dataset == "ROCOv2" else REPORTS
    name = "CT-RATE" if dataset == "rule-based" else dataset
    seen = {}
    for pkg, mod in (("jax", J_CLEAN), ("port", clean_reports)):
        d = tmp_path / pkg
        d.mkdir()
        (d / "train.json").write_text(json.dumps(items))
        calls = seen.setdefault(pkg, [])

        def fn(prompts, calls=calls, mod=mod):
            calls.append(list(prompts))
            return (mod._rule_based_fn if dataset == "rule-based" else _stub)(prompts)

        mod.clean_dataset(d, name, "train", fn, cleaner_name=dataset)
    assert seen["jax"] == seen["port"] and seen["port"]
    assert _same_files(tmp_path / "jax", tmp_path / "port") == 3


# ---- tag-reports ----

VL_ITEMS = [
    {"key": "s1", "image": ["s1.jpg"], "plane": ["PA"],
     "processed_report": "There is a nodule in the left lung. The heart is enlarged."},
    {"key": "s2", "image": ["s2.jpg"], "plane": ["PA"], "processed_report": "Cardiomegaly is present."},
    {"key": "s3", "image": ["s3.jpg"], "findings": "Small right pleural effusion.",
     "impression": "Atelectasis of the left lower lobe."},
    {"key": "s4", "image": ["s4.jpg"], "processed_report": ""},
]


def _fake_llm(prompts):
    """Valid markdown for the first report, a broken link for the rest
    (which then fall back to the taxonomy matcher)."""
    out = []
    for p in prompts:
        report = p.rsplit("Report: ", 1)[1].rsplit("\nAnnotated:", 1)[0]
        if "nodule" in report:
            out.append(report.replace("nodule", "[nodule](lung nodule)"))
        else:
            out.append(report.replace("Cardiomegaly", "[Cardiomegaly](heart"))
    return out


@pytest.mark.parametrize("route", ["taxonomy", "llm-stub"])
def test_tag_dataset_matches_jax(tmp_path, route):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "train.json").write_text(json.dumps(VL_ITEMS))
    fn = None if route == "taxonomy" else _fake_llm
    J_TAG.tag_dataset(tmp_path / "src", "train", tmp_path / "jax", fn, batch_size=3)
    tag_dataset(tmp_path / "src", "train", tmp_path / "port", fn, batch_size=3)
    assert _same_files(tmp_path / "jax", tmp_path / "port") == 1
    items = json.loads((tmp_path / "port" / "train.json").read_text())
    assert len(items) == 3 and all(i["tagger"] == ("llm" if fn else "taxonomy") for i in items)
    for i in items:
        for t in i["tags"]:
            assert i["ref_report"][t["start"]:t["end"]]


@pytest.fixture(scope="module")
def tiny_lm():
    """(JAX CogVLM tree, JAX config, JAX tokenizer, port params, port config,
    port tokenizer) at the tiny config, one seeded numpy tree."""
    tok, jtok = MMMMTokenizer.byte_fallback(), JaxTokenizer.byte_fallback()
    cfg, jcfg = MMMMConfig.tiny(vocab_size=len(tok)), JaxConfig.tiny(vocab_size=len(jtok))
    # rope tables long enough for the prompts: ~900 byte tokens a cleaning
    # prompt, ~4,600 a tagging prompt over the whole taxonomy
    cfg = dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, max_position_embeddings=8192))
    jcfg = dataclasses.replace(jcfg,
                               vlm=dataclasses.replace(jcfg.vlm, max_position_embeddings=8192))
    tree = numpy_params(cfg, 3)
    return (jax.tree.map(jnp.asarray, tree["cogvlm"]), jcfg.vlm, jtok,
            params_from_jax(tree, "cpu", cfg=cfg)["cogvlm"], cfg.vlm, tok)


SMALL_TAX = ("lung nodule", "left lung", "cardiomegaly", "pleural effusion", "atelectasis")


def test_llm_route_matches_jax(tmp_path, tiny_lm):
    """MIMIC's two cleaning passes, then the two tagging passes over their
    output, through each package's ``make_text_generator``: the port's
    static, continuous and speculative generators give the JAX static
    generator's texts, prompt for prompt, and the same files."""
    from mmmm_tpu.data.target_tax import get_target_tax as jax_target_tax

    jparams, jcfg, jtok, params, cfg, tok = tiny_lm
    taxes = {pkg: {k: v for k, v in get().items() if v.name in SMALL_TAX}
             for pkg, get in (("jax", jax_target_tax), ("port", get_target_tax))}
    kw = dict(max_new_tokens=6, batch_size=3, seq_quant=1024)  # one prompt bucket: one compile

    def recording(gen, log):
        def fn(prompts):
            out = gen(prompts)
            log.append((list(prompts), list(out)))
            return out
        return fn

    runs = {}
    gens = {"jax": jbatch.make_text_generator(jparams, jcfg, jtok, attn_impl="xla", **kw),
            "static": make_text_generator(params, cfg, tok, device="cpu", **kw),
            "continuous": make_text_generator(params, cfg, tok, continuous=True, device="cpu",
                                              **kw),
            "spec": make_text_generator(params, cfg, tok, continuous=True, speculate=3,
                                        device="cpu", **kw)}
    for label, gen in gens.items():
        d = tmp_path / label
        d.mkdir()
        (d / "train.json").write_text(json.dumps(REPORTS[:3]))
        log = runs.setdefault(label, [])
        pkg = "jax" if label == "jax" else "port"
        (J_CLEAN if pkg == "jax" else clean_reports).clean_dataset(
            d, "MIMIC-CXR", "train", recording(gen, log))
        shutil.copy(d / "train-processed.json", d / "tagged-in.json")
        (J_TAG.tag_dataset if pkg == "jax" else tag_dataset)(
            d, "tagged-in", d / "vg", recording(gen, log), target_tax=taxes[pkg])
    assert len(runs["jax"]) == 4 and max(len(p) for ps, _ in runs["jax"] for p in ps) > 600
    for label in ("static", "continuous", "spec"):
        assert runs[label] == runs["jax"], label
        assert _same_files(tmp_path / "jax", tmp_path / label) == 5


# ---- self-label ----

SAM_YAML = ("embed_dim: 32\nencoder_num_layers: 2\nencoder_num_heads: 4\n"
            "patch_size: [4, 4, 4]\npos_embed_shape: [2, 4, 4]\nnum_instances: 3\n"
            "decoder_mlp_dim: 64\n")


def _vg_dir(root: Path, rng) -> None:
    root.mkdir(parents=True)
    report = "The liver is normal. A nodule is seen."
    items = []
    for k, shape in enumerate([(1, 8, 32, 32), (1, 6, 24, 40), (1, 8, 32, 32)]):
        jax_save_pt_zst(rng.integers(0, 255, size=shape, dtype=np.uint8), root / f"case{k}.pt.zst")
        tags = [{"start": 4, "end": 9, "target": "liver"},
                {"start": 23, "end": 29, "target": "nodule"}][: 2 - k % 2]
        items.append({"key": f"case{k}", "image": [f"case{k}.pt.zst"], "ref_report": report,
                      "tags": tags if k < 2 else [{"start": 0, "end": 3, "target": "spleen"}]})
    (root / "train.json").write_text(json.dumps(items))


def test_self_label_matches_jax(tmp_path, monkeypatch):
    """The JAX script and the port's ``self-label`` over the same SAM npz,
    embeddings and volumes (``case2``'s one target has no embedding: no
    files). Each package's probabilities are read at its host resize back
    to the volume's shape (``resize_3d``'s second call a case)."""
    from mmmm_tpu.data import transforms as jtransforms
    from mmmm_tpu_torch.config import build, load_yaml
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.params import init_sam_params
    from mmmm_tpu_torch.train.checkpoint import save_adapter

    (tmp_path / "sam.yaml").write_text(SAM_YAML)
    cfg = build(SamConfig, load_yaml(tmp_path / "sam.yaml"))
    save_adapter(tmp_path / "sam.npz", init_sam_params(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "embeds.npz", liver=rng.normal(size=32), nodule=rng.normal(size=32))
    for pkg in ("jax", "port"):
        _vg_dir(tmp_path / pkg, np.random.default_rng(1))
    args = ["--sam", str(tmp_path / "sam.npz"), "--embeddings", str(tmp_path / "embeds.npz"),
            "--sam-config", str(tmp_path / "sam.yaml"), "--patch-size", "2", "4", "4",
            "--grid", "2", "4", "4"]

    def recorder(module, probs):
        resize = module.resize_3d

        def recorded(x, shape):
            out = resize(x, shape)
            if tuple(x.shape[1:]) == (4, 16, 16):  # the probabilities, back to the volume's shape
                probs.append(np.asarray(out))
            return out

        monkeypatch.setattr(module, "resize_3d", recorded)

    jprobs, pprobs = [], []
    recorder(jtransforms, jprobs)
    J_SELF_LABEL.main(["--vg-dir", str(tmp_path / "jax"), *args])
    recorder(self_label, pprobs)
    cli.main(["self-label", "--vg-dir", str(tmp_path / "port"), *args, "--device", "cpu"])
    assert len(pprobs) == len(jprobs) == 2
    assert [p.shape for p in jprobs] == [p.shape for p in pprobs] == [(2, 8, 32, 32),
                                                                      (1, 6, 24, 40)]
    tol = 1e-5
    for k, (pj, pp) in enumerate(zip(jprobs, pprobs)):
        np.testing.assert_allclose(pp, pj, atol=tol)
        mj = jax_load_pt_zst(tmp_path / "jax" / f"case{k}_seg.pt.zst")
        mp = jax_load_pt_zst(tmp_path / "port" / f"case{k}_seg.pt.zst")
        assert mp.dtype == np.bool_ and mp.shape == mj.shape == pp.shape
        far = np.abs(pp - 0.5) > tol
        assert far.any() and np.array_equal(mp[far], mj[far])
        assert np.array_equal(load_pt_zst(tmp_path / "jax" / f"case{k}_seg.pt.zst"), mj)
        for pkg in ("jax", "port"):
            assert (tmp_path / pkg / f"case{k}_seg.json").read_text() == \
                json.dumps(["liver", "nodule"][: 2 - k % 2])
    assert not (tmp_path / "port" / "case2_seg.pt.zst").exists()
    assert not (tmp_path / "jax" / "case2_seg.pt.zst").exists()


# ---- compress-vl ----

def test_compress_vl_matches_jax(tmp_path):
    """A PNG X-ray (cropped, kept in plane) and a deep ``.pt.zst`` CT volume
    (cropped, 150 -> 128 slices) through both packages, then a resumed run:
    the same tensors, ``.shape.json`` sidecars and rewritten JSON."""
    from PIL import Image

    rng = np.random.default_rng(0)
    src = tmp_path / "raw"
    (src / "p10" / "p100" / "s1").mkdir(parents=True)
    arr = np.zeros((300, 700), np.uint8)
    arr[40:260, 60:600] = rng.integers(30, 255, (220, 540))
    Image.fromarray(arr).save(src / "p10" / "p100" / "s1" / "x.png")
    vol = np.zeros((1, 150, 40, 48), np.int16)
    vol[:, 5:148, 2:38, 4:44] = rng.integers(-900, 1500, (1, 143, 36, 40))
    save_pt_zst(vol, src / "p10" / "p100" / "s1" / "ct.pt.zst")
    items = [{"image": [str(src / "p10" / "p100" / "s1" / "x.png")], "modality": ["X-Ray"],
              "findings": "f"},
             {"image": ["p10/p100/s1/ct.pt.zst", "p10/missing.png"], "modality": ["CT", "CT"]},
             {"image": [str(src / "p10" / "p100" / "s1" / "empty.png")]}]
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(src / "p10" / "p100" / "s1" / "empty.png")
    (tmp_path / "train.json").write_text(json.dumps(items))
    base = ["--data", str(tmp_path), "--image-root", str(src), "--splits", "train", "test"]
    for _ in range(2):  # the second run resumes
        J_COMPRESS.main([*base, "--out", str(tmp_path / "jax")])
        cli.main(["compress-vl", *base, "--out", str(tmp_path / "port")])
        res = json.loads((tmp_path / "port" / "train.json").read_text())
        assert len(res) == 2 and res[0]["modality"] == ["X-ray"] and res[1]["shape"][1] is None
        for pkg in ("jax", "port"):
            out = tmp_path / pkg / "p10" / "p100" / "s1"
            assert jax_load_pt_zst(out / "x.pt.zst").shape == (1, 1, 220, 540)
            assert load_pt_zst(out / "ct.pt.zst").shape == (1, 128, 36, 40)
        assert _same_files(tmp_path / "jax", tmp_path / "port") == 5
    for shape in ((300, 640, 640), (1, 400, 800), (1, 600, 1200), (7, 90, 300)):
        assert compress_vl.get_resize(shape) == J_COMPRESS.get_resize(shape)


# ---- convert-vl ----

def _png(path: Path, value: int = 0):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.full((8, 8), value, np.uint8)).save(path)


def _write_csv(path: Path, rows: list[dict]):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _convert_inputs(fmt: str, src: Path) -> list:
    """The raw layout of ``fmt`` under ``src``; returns the extra argv."""
    from test_vl_converters import REPORT, _write_mimic_tree

    if fmt == "vqa-json":
        rows = [{"image_name": f"img{i % 3}.jpg", "question": f"q{i}?", "answer": i,
                 "phase": ["train", "val", "test"][i % 3]} for i in range(7)]
        src.mkdir(parents=True)
        (src / "vqa.json").write_text(json.dumps(rows))
        return ["--src", str(src / "vqa.json"), "--split-field", "phase", "--image-dir", "imgs"]
    if fmt == "report-folder":
        for k, body in enumerate([REPORT, "FINDINGS: Small left pleural effusion. Heart is "
                                  "enlarged.\nIMPRESSION: Cardiomegaly.", "No sections."]):
            _png(src / f"r{k}.png", k)
            (src / f"r{k}.txt").write_text(body)
        (src / "orphan.txt").write_text(REPORT)
        return ["--src", str(src), "--split", "test"]
    if fmt == "mimic-cxr":
        split_csv, jpg_root, meta = _write_mimic_tree(src)
        return ["--src", str(src / "files"), "--split-csv", str(split_csv), "--image-dir",
                str(jpg_root), "--metadata-csv", str(meta)]
    if fmt == "ct-rate":
        name = "train_1_a_1.nii.gz"
        _write_csv(src / "radiology_text_reports" / "train_reports.csv",
                   [{"VolumeName": name, "Findings_EN": "Nodular opacity in the right lobe.",
                     "Impressions_EN": "Pulmonary nodule."}])
        cols = ["VolumeName"] + [c for c, _ in J_CONVERT.CT_RATE_LABELS]
        row = dict.fromkeys(cols, "0") | {"VolumeName": name, "Lung nodule": "1",
                                          "Emphysema": "1.0"}
        _write_csv(src / "multi_abnormality_labels" / "train_predicted_labels.csv", [row])
        (src / "train" / "train_1" / "train_1_a").mkdir(parents=True)
        (src / "train" / "train_1" / "train_1_a" / name).write_bytes(b"x")
        _write_csv(src / "meta.csv", [{"VolumeName": name, "RescaleSlope": "1",
                                       "RescaleIntercept": "-1024", "XYSpacing": "[0.75, 0.75]",
                                       "ZSpacing": "1.5"}])
        return ["--src", str(src), "--metadata-csv", str(src / "meta.csv")]
    if fmt == "label":
        src.mkdir(parents=True)
        (src / "train.json").write_text(json.dumps([
            {"key": "a", "findings": "There is a large pleural effusion.", "impression": "Eff."},
            {"key": "b", "processed_report": "Clear lungs. Heart is enlarged."}]))
        return ["--src", str(src)]
    if fmt == "openi":
        for uid, n in (("1", 2), ("2", 1), ("3", 1), ("4", 1)):
            for k in range(n):
                _png(src / "images" / "images_normalized" / f"{uid}_IM-{k}.dcm.png", k)
        _write_csv(src / "indiana_reports.csv", [
            {"uid": "1", "findings": "Clear lungs.", "impression": "Normal."},
            {"uid": "2", "findings": "", "impression": "Normal."},
            {"uid": "3", "findings": "Opacity.", "impression": "Pneumonia."},
            {"uid": "4", "findings": "Effusion.", "impression": "Effusion."}])
        return ["--src", str(src)]
    if fmt == "rocov2":
        _write_csv(src / "validation_captions.csv",
                   [{"ID": "ROCOv2_0001", "Caption": "CT of the chest."},
                    {"ID": "ROCOv2_0002", "Caption": "MRI, axial."}])
        return ["--src", str(src), "--split", "validation"]
    if fmt == "pmc-oa":
        root = src / "caption_T060_filtered_top4_sep_v0_subfigures"
        _png(root / "a.jpg")
        _png(root / "b.jpg")
        (root / "broken.jpg").write_bytes(b"not an image")
        rows = [{"image": "a.jpg", "caption": "  the chest radiograph shows nodules  "},
                {"image": "b.jpg", "caption": "short"},
                {"image": "broken.jpg", "caption": "A long enough caption here."},
                {"image": "missing.jpg", "caption": "Another long caption text."}]
        (src / "pmc_oa.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
        return ["--src", str(src), "--num-val", "1"]
    if fmt == "radiopaedia":
        src.mkdir(parents=True)
        mount = J_CONVERT.RADFM_MOUNT
        (src / "rp.json").write_text(json.dumps([
            {"image_path": [f"{mount}/case1/vol.npy", f"{mount}/gone/x.nii.gz"],
             "image_modality": ["CT ", "MRI"], "plane_projection": ["Axial", "weird"],
             "finding": " Large mass. ", "qa_list": [{"question": "q", "answer": "a"}]},
            {"image_path": [f"{mount}/case1/vol.npy"], "image_modality": ["CT"],
             "plane_projection": [None], "finding": None, "qa_list": []}]))
        return ["--src", str(src), "--json-file", "rp.json"]
    assert fmt == "vqa-med"
    tr = src / "ImageClef-2019-VQA-Med-Training"
    tr.mkdir(parents=True)
    (tr / "All_QA_Pairs_train.txt").write_text(
        "img2|what modality?|xray\nimg1|what plane?|axial\nimg1|normal?|yes \n")
    _png(tr / "Train_images" / "img1.jpg")
    te = src / "VQAMed2019Test"
    te.mkdir()
    (te / "VQAMed2019_Test_Questions_w_Ref_Answers.txt").write_text(
        "img9|modality|what modality?|ct\n")
    return ["--src", str(src)]


@pytest.mark.parametrize("fmt", ["vqa-json", "report-folder", "mimic-cxr", "ct-rate", "label",
                                 "openi", "rocov2", "pmc-oa", "radiopaedia", "vqa-med"])
def test_convert_vl_matches_jax(tmp_path, fmt):
    """Each format through the JAX script's ``main`` and the port's
    ``convert-vl``, from inputs of their own: the same files (``label``
    rewrites its input in place)."""
    outs = {}
    for pkg in ("jax", "port"):
        argv = ["--format", fmt, *_convert_inputs(fmt, tmp_path / pkg / "src"),
                "--out", str(tmp_path / pkg / "out")]
        if fmt == "radiopaedia":  # images the converter keeps must exist under --out
            img = tmp_path / pkg / "out" / "images" / "case1" / "vol.pt.zst"
            img.parent.mkdir(parents=True)
            save_pt_zst(np.zeros((1, 2, 2, 2), np.uint8), img)
        if pkg == "jax":
            J_CONVERT.main(argv)
        else:
            cli.main(["convert-vl", *argv])
        outs[pkg] = tmp_path / pkg
    if fmt == "label":  # in place
        assert _same_files(outs["jax"], outs["port"]) == 1
        assert "keyword" in (outs["port"] / "src" / "train.json").read_text()
    else:
        assert _same_files(outs["jax"], outs["port"]) > 1
        assert (outs["port"] / "out").is_dir()


def test_label_reports_refuses_without_chexbert(tmp_path):
    """``--format label --chexbert-ckpt`` without the checkpoint raises (the
    keyword labeler is not taken in its place), before any file changes."""
    (tmp_path / "train.json").write_text(json.dumps([{"key": "a", "findings": "Clear."}]))
    before = (tmp_path / "train.json").read_bytes()
    with pytest.raises((FileNotFoundError, ImportError, RuntimeError)):
        convert_vl.label_reports(tmp_path, "train", chexbert_ckpt=tmp_path / "missing.pth")
    assert (tmp_path / "train.json").read_bytes() == before


# ---- the commands at --device cpu ----

def test_llm_commands_through_params_file(tmp_path, tiny_lm):
    """``clean-reports`` (static) and ``tag-reports`` (``--continuous``)
    through ``--params`` (the CogVLM tree written by the JAX package's
    ``save_params``) and ``--config`` at ``--device cpu``: the files of
    ``clean_dataset``/``tag_dataset`` over the in-memory generators. The
    rule-based and taxonomy routes need no model; no route, or the card
    where there is none, raises."""
    from mmmm_tpu.train.checkpoint import save_params

    jparams, jcfg, _, params, cfg, tok = tiny_lm
    save_params(tmp_path / "lm.npz", jax.device_get(jparams))
    conf = {k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                         "num_hidden_layers", "num_attention_heads",
                                         "max_position_embeddings")}
    (tmp_path / "lm.json").write_text(json.dumps(conf))
    lm = ["--params", str(tmp_path / "lm.npz"), "--config", str(tmp_path / "lm.json"),
          "--max-new-tokens", "4", "--device", "cpu"]
    d, ref = tmp_path / "cli", tmp_path / "ref"
    for x in (d, ref):
        x.mkdir()
        (x / "train.json").write_text(json.dumps(REPORTS[:2]))
    cli.main(["clean-reports", "--dir", str(d), "--dataset", "OpenI", *lm])
    clean_reports.clean_dataset(ref, "OpenI", "train", make_text_generator(
        params, cfg, tok, max_new_tokens=4, device="cpu"), cleaner_name="llm")
    # the whole taxonomy's prompts (~4,600 tokens) cut to the server's 1,024
    cli.main(["tag-reports", "--dir", str(d), "--split", "train-processed", "--out",
              str(d / "vg"), *lm, "--continuous"])
    tag_dataset(ref, "train-processed", ref / "vg", make_text_generator(
        params, cfg, tok, max_new_tokens=4, continuous=True, device="cpu"))
    assert _same_files(ref, d) == 4
    cli.main(["clean-reports", "--dir", str(d), "--dataset", "CT-RATE", "--rule-based"])
    cli.main(["tag-reports", "--dir", str(d), "--out", str(d / "tax"), "--taxonomy-only"])
    assert json.loads((d / "train-processed.json").read_text())[0]["cleaner"] == "rule-based"
    assert json.loads((d / "tax" / "train.json").read_text())[0]["tagger"] == "taxonomy"
    with pytest.raises(SystemExit):
        cli.main(["tag-reports", "--dir", str(d), "--out", str(d / "x")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["clean-reports", "--dir", str(d), "--dataset", "OpenI", *lm[:4]])
