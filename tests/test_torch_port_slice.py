"""The port's grounded report path as a whole, its parameter bridge and its
isolation from JAX.

``generate_grounded`` at ``MMMMConfig.tiny()`` in fp32 on the CPU, with the
byte tokenizer and three right-padded prompts of unequal length, against
``mmmm_tpu.models.inference.generate_grounded(attn_impl="xla")``: tokens,
``num_generated``, texts and parsed targets identical, masks within atol
2e-4 (the tolerance of tests/test_serving.py).
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmm_tpu.data.tokenizer import MMMMTokenizer as JaxTokenizer
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import MMMMModel
from mmmm_tpu.models import inference as jinf
from mmmm_tpu.models.cogvlm import CogVLMConfig as JaxCogVLMConfig
from mmmm_tpu.models.segvol import SamConfig as JaxSamConfig
from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, generate_grounded,
                            init_params, init_train_state, make_optimizer, make_train_step,
                            params_from_jax)
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.params import _flatten, param_spec
from test_torch_port_models import numpy_params, one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N_VIS = 1 * 4 * 4 + 2  # (3, 4, 16, 16) image, patch 4, pool 1 -> 16 tokens + boi/eoi
PATCH, POOL = (4, 4, 4), (1, 1, 1)


def _ground_head(tree, tok):
    """Bias the lm_head columns of ``<p>``, ``</p>`` and two byte tokens
    toward the embedding of the token before them, so that the random model
    writes ``a<p>z</p>a<p>z...`` and real spans are generated and parsed;
    byte 2 leads to eos, which ends one sample early."""
    llm = tree["cogvlm"]["llm"]
    emb, head = llm["embed_tokens"], llm["lm_head"]
    a, z = 3 + ord("a"), 3 + ord("z")
    for src, dst in [(a, tok.bop_token_id), (tok.bop_token_id, z), (z, tok.eop_token_id),
                     (tok.eop_token_id, a), (5, tok.eos_token_id)]:
        head[:, dst] += 0.5 * emb[src] / np.linalg.norm(emb[src])


def _prompts(b=3):
    rng = np.random.default_rng(0)
    lens = [1 + N_VIS + t for t in (5, 9, 7)][:b]
    s = max(lens)
    ids = np.zeros((b, s), np.int32)
    tt = np.zeros_like(ids)
    pos = np.zeros_like(ids)
    for i, n in enumerate(lens):
        text = n - 1 - N_VIS
        ids[i, :n] = np.concatenate([[1], np.full(N_VIS, 3), rng.integers(4, 250, size=text)])
        tt[i, 1:1 + N_VIS] = 1
        pos[i, :n] = np.concatenate([[0, 1], np.full(N_VIS - 2, 2), [3], np.arange(4, 4 + text)])
    img = rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32)
    gimg = rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32)
    return ids, tt, pos, np.asarray(lens, np.int32), img, gimg


def test_generate_grounded_matches_jax():
    tok = MMMMTokenizer.byte_fallback()
    jtok = JaxTokenizer.byte_fallback()
    cfg = MMMMConfig.tiny(vocab_size=len(tok))
    jcfg = JaxConfig.tiny(vocab_size=len(jtok))
    tree = numpy_params(cfg, 2)
    _ground_head(tree, tok)
    ids, tt, pos, lens, img, gimg = _prompts()
    kw = dict(max_new_tokens=8, max_targets=2, force_grounding=True, vis_span=(1, 1 + N_VIS))

    jparams = jax.tree.map(jnp.asarray, tree)
    ref = jinf.generate_grounded(
        jparams, jcfg, jtok, *(jnp.asarray(x) for x in (ids, tt, pos, lens, img)), PATCH, POOL,
        grounding_image=jnp.asarray(gimg), attn_impl="xla", **kw)
    # the jitted stage generate_grounded just ran (lru-cached): its num_generated
    stage = jinf._generate_stage(jcfg, 8, jtok.eos_token_id, jtok.bop_token_id,
                                 jtok.eop_token_id, PATCH, POOL, "xla", True, (1, 1 + N_VIS),
                                 "bf16", 0, 0, False, 1, True, "all")
    ref_gen, _ = stage(jparams, *(jnp.asarray(x) for x in (ids, tt, pos, lens, img)))

    got = generate_grounded(params_from_jax(tree, "cpu", cfg=cfg), cfg, tok, ids, tt, pos, lens,
                            img, PATCH, POOL, grounding_image=gimg, device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated, np.asarray(ref_gen.num_generated))
    assert got.text == ref.text
    assert got.targets == ref.targets
    # the fixture exercises the span parse (two samples write "<p>z</p>"
    # twice) and eos masking (the third stops after one token)
    assert got.targets[:2] == [["z", "z"], ["z", "z"]]
    assert got.num_generated.tolist() == [8, 8, 1]
    np.testing.assert_array_equal(got.target_valid, ref.target_valid)
    assert got.masks.shape == (3, 2, 4, 16, 16)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(ref.masks), atol=2e-4, rtol=0)


def test_tokenizer_matches_jax():
    tok, jtok = MMMMTokenizer.byte_fallback(), JaxTokenizer.byte_fallback()
    for text in ["plain", "a <p> liver</p> and <np>lung</np>", "<sys><usr>é<grd>"]:
        assert tok.encode(text) == jtok.encode(text)
        assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text))
    ids = np.array([[tok.bop_token_id, 3 + 65, tok.eop_token_id, 9],
                    [tok.eop_token_id, 4, 5, 6]])
    assert tok.parse_targets(ids) == jtok.parse_targets(ids)
    assert tok.parse_targets(ids, True) == jtok.parse_targets(ids, True)


def _jax_tree(cfg, dtype=jnp.float32):
    """Shapes and dtypes of ``MMMMModel(cfg).init``, without running it."""
    return jax.eval_shape(lambda k: MMMMModel(cfg).init(k, dtype), jax.random.PRNGKey(0))


def test_params_from_jax_consumes_every_leaf():
    cfg = MMMMConfig.tiny()
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), _jax_tree(JaxConfig.tiny()))
    params = params_from_jax(tree, "cpu", cfg=cfg)
    flat, spec = _flatten(params), _flatten(param_spec(cfg))
    assert flat.keys() == spec.keys() == _flatten(tree).keys()
    assert all(tuple(flat[k].shape) == spec[k].shape for k in spec)

    missing = {**tree, "vg_proj": {k: v for k, v in tree["vg_proj"].items() if k != "b2"}}
    with pytest.raises(ValueError, match="left unset.*vg_proj/b2"):
        params_from_jax(missing, "cpu")
    extra = {**tree, "vg_proj": {**tree["vg_proj"], "b3": np.zeros(1, np.float32)}}
    with pytest.raises(ValueError, match="not consumed.*vg_proj/b3"):
        params_from_jax(extra, "cpu")
    bad = {**tree, "vg_proj": {**tree["vg_proj"], "b2": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="vg_proj/b2 has shape"):
        params_from_jax(bad, "cpu", cfg=cfg)


def test_param_spec_matches_jax_init_at_flagship():
    """The port's layout, shapes and precision classes are the JAX init's at
    the flagship width (checked on shapes only: nothing is allocated)."""
    cfg = MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())
    jcfg = JaxConfig(vlm=JaxCogVLMConfig.cogvlm17b(), sam=JaxSamConfig())
    jflat = _flatten(_jax_tree(jcfg, jnp.bfloat16))
    spec = _flatten(param_spec(cfg))
    assert jflat.keys() == spec.keys()
    for k, leaf in spec.items():
        assert tuple(jflat[k].shape) == leaf.shape, k
        assert (jflat[k].dtype == jnp.float32) == leaf.fp32, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params(dtype):
    cfg = MMMMConfig.tiny()
    a, b, c = (init_params(cfg, seed, dtype, "cpu") for seed in (0, 0, 1))
    fa, fb, fc = _flatten(a), _flatten(b), _flatten(c)
    spec = _flatten(param_spec(cfg))
    assert fa.keys() == spec.keys()
    for k, leaf in spec.items():
        assert tuple(fa[k].shape) == leaf.shape
        assert fa[k].dtype == (torch.float32 if leaf.fp32 else dtype)
        assert torch.equal(fa[k], fb[k])
    assert not torch.equal(fa["cogvlm/llm/lm_head"], fc["cogvlm/llm/lm_head"])


def test_default_device_is_the_card():
    """Without ``device="cpu"`` the entry points run on CUDA; with no card
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = MMMMConfig.tiny()
    tok = MMMMTokenizer.byte_fallback()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, torch.float32, "cpu")
    ids, tt, pos, lens, img, _ = _prompts(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_grounded(params, cfg, tok, ids, tt, pos, lens, img, PATCH, POOL,
                          max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, "cuda")
    opt, lcfg = make_optimizer(OptimizerConfig()), LoraConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(cfg, opt, lcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, opt, lcfg)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


PREPROCESS_MODULES = ("nifti", "dicom", "processor", "seg_folder", "boxes", "registry",
                      "report", "tagging", "clean_reports", "tag_reports", "self_label",
                      "compress_vl", "convert_vl")
PARALLEL_MODULES = ("mesh", "sharding", "distributed", "zero", "debug", "tensor")


def test_port_imports_no_jax_and_no_library_kernels():
    """No module of the port, and neither chip_smoke.py nor the timing
    scripts beside it, imports jax, jaxlib, mmmm_tpu (the ``mmmm_tpu.``
    pattern leaves ``mmmm_tpu_torch`` alone) or zstandard (zstd is the
    port's own native library, with its own copy of the C++ source), and no
    module of the port calls SDPA or torch.compile (chip_smoke.py times
    SDPA as a yardstick)."""
    files = sorted((ROOT / "mmmm_tpu_torch").rglob("*.py"))
    assert len(files) > 15
    for rel in (("ops", "w4_matmul.py"), ("ops", "flash.py"), ("peft", "lora.py"),
                ("train", "step.py"), ("train", "optim.py"), ("train", "import_torch.py"),
                ("train", "peft_export.py"), ("data", "infer_transform.py"),
                ("eval", "metrics.py"), ("eval", "models.py"), ("eval", "radgraph.py"),
                ("ops", "hungarian.py"), ("ops", "deform_attn.py"), ("models", "detector.py"),
                ("models", "unet.py"), ("train", "detector.py"), ("train", "seg_exp.py"),
                ("utils", "native.py"), ("utils", "io.py"), ("utils", "viewer.py"),
                ("eval", "baselines.py"), ("train", "baselines.py"),
                *(("preprocess", f"{m}.py") for m in PREPROCESS_MODULES),
                *(("parallel", f"{m}.py") for m in PARALLEL_MODULES)):
        assert ROOT.joinpath("mmmm_tpu_torch", *rel) in files
    scripts = [ROOT / n for n in ("chip_smoke.py", "time_decode_reads.py",
                                  "time_flagship_runs.py", "time_flagship_profile.py")]
    for f in files + scripts:
        tree = ast.parse(f.read_text(), filename=str(f))
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mmmm_tpu", "zstandard"), f"{f}: imports {mod}"
        if f in scripts:
            continue
        attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not attrs & {"scaled_dot_product_attention", "compile"}, f


def test_import_leaves_jax_out():
    """Importing every module of the port, and chip_smoke.py, loads no JAX,
    and none of ``zstandard``, ``PIL``, ``yaml``, ``safetensors`` and
    ``transformers``, which the card's machine lacks (each is imported where
    a file or a scorer that needs it is used; the port reads and writes
    safetensors files itself)."""
    code = ("import importlib, pkgutil, sys, mmmm_tpu_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(mmmm_tpu_torch.__path__, 'mmmm_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "for m in ('jax', 'zstandard', 'PIL', 'yaml', 'safetensors', 'transformers'):\n"
            "    assert m not in sys.modules, m + ' imported'\n"
            "for m in ('ops.w4_matmul', 'peft.lora', 'train.step', 'train.optim',\n"
            "          'train.trainer', 'data.dataset', 'utils.io', 'models.align', 'cli',\n"
            "          'train.import_torch', 'train.peft_export', 'data.infer_transform',\n"
            "          'eval.models', 'eval.radgraph', 'models.segvol.sam', 'ops.hungarian',\n"
            "          'ops.deform_attn', 'models.detector', 'models.unet', 'train.detector',\n"
            "          'train.seg_exp', 'utils.native', 'utils.viewer', 'eval.baselines',\n"
            "          'train.baselines', " + ", ".join(f"'preprocess.{m}'" for m in PREPROCESS_MODULES)
            + ", " + ", ".join(f"'parallel.{m}'" for m in PARALLEL_MODULES) + "):\n"
            "    assert 'mmmm_tpu_torch.' + m in sys.modules, m")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_fit_configs_mirror_the_yaml():
    """chip_smoke.py builds its fit configs as dicts (the card has no
    PyYAML): ``TINY_FIT`` is conf/tiny/fit.yaml as ``load_yaml`` resolves
    it (tiny_fit_phase overrides only the dataset, ``vl_trans``, the
    output directory, the step counts and the fp32 switches), the flagship
    fit's data ``conf`` and ``vl_trans`` are conf/phase-vlm/data.yaml's
    (flagship_fit_phase adds ``log2_patch_size_z_std: 0``), and its LoRA
    is conf/lora.yaml."""
    import chip_smoke
    from mmmm_tpu_torch.config import load_yaml

    assert chip_smoke.TINY_FIT == load_yaml(ROOT / "conf" / "tiny" / "fit.yaml")
    vlm = load_yaml(ROOT / "conf" / "phase-vlm" / "data.yaml")
    assert chip_smoke.PHASE_VLM_DATA == {"conf": vlm["conf"], "vl_trans": vlm["vl_trans"]}
    assert "log2_patch_size_z_std" not in vlm["vl_trans"]
    assert chip_smoke.LORA_YAML == load_yaml(ROOT / "conf" / "lora.yaml")
    phase = load_yaml(ROOT / "conf" / "phase-vlm" / "fit.yaml")
    assert phase["optimizer"]["lr"] == 5e-5 and phase["lora"] == chip_smoke.LORA_YAML
