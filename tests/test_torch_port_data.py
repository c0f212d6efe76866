"""The port's data layer (``mmmm_tpu_torch/data``, ``utils/io.py``,
``build.build_dataset``) against the JAX package's, on the CPU.

The same synthetic datasets on disk (the helpers and fixtures of
tests/test_data_pipeline.py and tests/test_vl_grg.py, and the ``.pt``
vision-language dataset that chip_smoke.py writes for the card) go through
both packages' transforms under the same ``RandomState``: token ids,
labels, weights, position and type ids, masks, boxes, offsets, label masks,
texts, patch and pool sizes and the metadata-only plans exactly equal;
images within 1e-6 (``resize_3d`` runs the port's torch resampler where
the JAX package runs its own, over the same interpolation matrices). The
sampler and the scheduled batch stream over a seg + box + vl
``MultiDataset`` give the same bucket keys and modes in the same order,
with equal arrays; ``build_dataset`` builds the same dataset from a dict;
``.pt.zst`` and ``.arr.zst`` files are byte-equal between the packages.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from chip_smoke import write_vl_dataset
from mmmm_tpu import build as jbuild
from mmmm_tpu.config import build as jax_build_cfg
from mmmm_tpu.data import batching as jbatching
from mmmm_tpu.data import grg as jgrg
from mmmm_tpu.data import local as jlocal
from mmmm_tpu.data import sampling as jsampling
from mmmm_tpu.data import transforms as jtransforms
from mmmm_tpu.data import vl as jvl
from mmmm_tpu.data.input_builder import VLMInputs as JaxVLMInputs
from mmmm_tpu.data.tokenizer import MMMMTokenizer as JaxTokenizer
from mmmm_tpu.utils import io as jio
from mmmm_tpu_torch import build as pbuild
from mmmm_tpu_torch.config import build as build_cfg
from mmmm_tpu_torch.data import batching, grg, local, sampling, transforms, vl
from mmmm_tpu_torch.data.input_builder import VLMInputs
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.utils import io as pio
from test_data_pipeline import _make_box_case, _make_seg_case
from test_vl_grg import grg_box_dataset, grg_seg_dataset, vl_dataset  # noqa: F401 (fixtures)

DATA_CONF = {"base_vit_patch_size_z": 4, "vit_patch_size_xy": 4, "pool_size_xy": 1,
             "base_pool_size_z": 1, "max_seq_len": 640, "max_targets": 4, "max_instances": 8,
             "local_trans": {"max_vision_tokens": 64, "max_tokens_z": 4, "num_pos": 2,
                             "num_neg": 1}}
VL_TRANS = {"max_tokens": 64, "max_tokens_z": 4}
SEEDS = (0, 1, 2)


def _confs(grg_trans: dict | None = None):
    """The same DatasetConf in each package, with vl_trans and grg_trans."""
    pc, jc = build_cfg(local.DatasetConf, DATA_CONF), jax_build_cfg(jlocal.DatasetConf, DATA_CONF)
    pc.vl_trans, jc.vl_trans = build_cfg(vl.VLTransConf, VL_TRANS), \
        jax_build_cfg(jvl.VLTransConf, VL_TRANS)
    gt = {**VL_TRANS, **(grg_trans or {})}
    pc.grg_trans, jc.grg_trans = build_cfg(grg.GRGTransConf, gt), \
        jax_build_cfg(jgrg.GRGTransConf, gt)
    return pc, jc


def assert_same(got, want, path="dp"):
    """Port output ``got`` equals JAX output ``want``: floating arrays named
    image within 1e-6, every other leaf exactly."""
    if isinstance(want, JaxVLMInputs):
        assert isinstance(got, VLMInputs), path
        for f in dataclasses.fields(JaxVLMInputs):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, type(got))
        assert got.shape == want.shape, (path, got.shape, want.shape)
        if "image" in path.rsplit(".", 1)[-1]:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)) and any(isinstance(w, np.ndarray) for w in want):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def local_datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("local")
    for i in range(3):
        _make_seg_case(root / "SegSet", f"case{i}", rng=np.random.default_rng(i))
    for i in range(2):
        _make_box_case(root / "BoxSet", f"case{i}")
    return {"seg": root / "SegSet", "box": root / "BoxSet"}


@pytest.fixture(scope="module")
def vl_pt_dataset(tmp_path_factory):
    """chip_smoke.py's tiny-fit dataset: random ``.pt`` volumes, reports, VQA."""
    return write_vl_dataset(tmp_path_factory.mktemp("vl") / "VLSet", 4, (1, 8, 32, 32),
                            report_chars=200, seed=0)


def _pairs(kind: str, paths: dict, grg_trans=None):
    """(port transform, JAX transform, port items, JAX items) of a dataset."""
    pc, jc = _confs(grg_trans)
    ptok, jtok = MMMMTokenizer.byte_fallback(), JaxTokenizer.byte_fallback()
    d = paths[kind]
    if kind in ("seg", "box"):
        return (local.LocalTransform(pc, ptok), jlocal.LocalTransform(jc, jtok),
                local.get_local_data_list(d), jlocal.get_local_data_list(d))
    if kind in ("vl_pt", "vl_png"):
        return (vl.VLTransform(pc, ptok), jvl.VLTransform(jc, jtok),
                vl.get_vl_data_list(d), jvl.get_vl_data_list(d))
    return (grg.GRGTransform(pc, ptok), jgrg.GRGTransform(jc, jtok),
            grg.get_grg_data_list(d), jgrg.get_grg_data_list(d))


@pytest.mark.parametrize("kind,grg_trans", [
    ("seg", None), ("box", None), ("vl_pt", None), ("vl_png", None),
    ("grg_box", {"grounding_prob": 1.0, "equalize": True}), ("grg_box", None),
    ("grg_seg", {"grounding_prob": 1.0}),
])
def test_transform_matches_jax(kind, grg_trans, local_datasets, vl_pt_dataset, vl_dataset,
                               grg_box_dataset, grg_seg_dataset):
    """Every sample of the dataset under seeds 0-2: the full transform and
    the metadata-only plan equal JAX's."""
    paths = {**local_datasets, "vl_pt": vl_pt_dataset, "vl_png": vl_dataset,
             "grg_box": grg_box_dataset, "grg_seg": grg_seg_dataset}
    ptf, jtf, pitems, jitems = _pairs(kind, paths, grg_trans)
    assert len(pitems) == len(jitems) > 0
    modes = set()
    for seed in SEEDS:
        for p_item, j_item in zip(pitems, jitems):
            for plan_only in (False, True):
                got = ptf(p_item, rng=np.random.RandomState(seed), plan_only=plan_only)
                want = jtf(j_item, rng=np.random.RandomState(seed), plan_only=plan_only)
                assert_same(got, want)
            modes.add((want["grounding"], want["instance"]))
    if kind in ("seg", "grg_seg"):
        assert (True, False) in modes
    if kind in ("box", "grg_box") and grg_trans:
        assert (True, True) in modes


@pytest.mark.parametrize("src,dst", [((2, 5, 7, 9), (3, 11, 4)), ((1, 1, 13, 6), (1, 5, 17)),
                                     ((3, 8, 64, 48), (8, 17, 33)), ((2, 3, 3, 3), (3, 3, 3))])
def test_resize_3d_matches_jax(src, dst):
    x = np.random.default_rng(0).uniform(size=src).astype(np.float32)
    got, want = transforms.resize_3d(x, dst), jtransforms.resize_3d(x, dst)
    assert got.dtype == np.float32 and got.shape == want.shape == (src[0], *dst)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [1, 3])
def test_sampler_matches_jax(world):
    """The same (dataset, index) sequence, per-sample weights and shards."""
    w = jsampling.mimic_neg_weights(np.arange(40) % 3 == 0, 0.2)
    np.testing.assert_array_equal(sampling.mimic_neg_weights(np.arange(40) % 3 == 0, 0.2), w)
    p_specs = [sampling.DatasetSpec("a", 1.0), sampling.DatasetSpec("b", 2.5, w)]
    j_specs = [jsampling.DatasetSpec("a", 1.0), jsampling.DatasetSpec("b", 2.5, w)]
    for rank in range(world):
        got = list(sampling.WeightedMultiDatasetSampler(p_specs, [7, 40], 300, seed=5,
                                                        rank=rank, world_size=world))
        want = list(jsampling.WeightedMultiDatasetSampler(j_specs, [7, 40], 300, seed=5,
                                                          rank=rank, world_size=world))
        assert got == want and len(got) == 300 // world
    for pos in (0, 17):
        assert sampling.sample_rng(3, pos).randint(1 << 30, size=4).tolist() == \
            jsampling.sample_rng(3, pos).randint(1 << 30, size=4).tolist()


def _data_cfg(local_datasets, vl_pt_dataset) -> dict:
    return {"conf": DATA_CONF, "vl_trans": VL_TRANS,
            "datasets": [{"name": "SegSet", "type": "local", "dir": str(local_datasets["seg"])},
                         {"name": "BoxSet", "type": "local", "dir": str(local_datasets["box"]),
                          "weight": 2.0},
                         {"name": "VLSet", "type": "vl", "dir": str(vl_pt_dataset)},
                         {"name": "Absent", "type": "vl", "dir": "absent"}]}


def test_build_dataset_and_batch_stream_match_jax(local_datasets, vl_pt_dataset, tmp_path):
    """``build_dataset`` from one dict (a missing dataset skipped), then
    ``scheduled_batches`` at B = 2 over 24 samples: the same batches (bucket
    key, mode and every array) in the same order."""
    cfg = _data_cfg(local_datasets, vl_pt_dataset)
    pds = pbuild.build_dataset(cfg, MMMMTokenizer.byte_fallback(), tmp_path)
    jds = jbuild.build_dataset(cfg, JaxTokenizer.byte_fallback(), tmp_path)
    assert pds.sizes() == jds.sizes() == [3, 2, 4]
    assert [dataclasses.astuple(s) for s in pds.specs] == \
        [dataclasses.astuple(s) for s in jds.specs]
    assert dataclasses.asdict(pds.conf) == dataclasses.asdict(jds.conf)
    args = dict(eop_token_id=pds.transforms["vl"].tokenizer.eop_token_id, max_targets=4,
                max_instances=8, max_seq_len=640)
    got = list(batching.scheduled_batches(pds, batching.BucketBatcher(2, **args), 24, seed=7))
    want = list(jbatching.scheduled_batches(jds, jbatching.BucketBatcher(2, **args), 24, seed=7))
    assert len(got) == len(want) >= 10
    assert {b["vg_mode"] for b in want} == {"none", "semantic", "instance"}
    for g, w in zip(got, want):
        assert_same(g, w, "batch")


def test_multidataset_stream_and_mimic_weights(vl_pt_dataset, tmp_path):
    """``MultiDataset.stream`` (no plans) equals JAX's, with MIMIC-CXR's
    negative-report reweighting."""
    items = json.loads((vl_pt_dataset / "train-processed.json").read_text())
    mimic = tmp_path / "MIMIC-CXR"
    mimic.mkdir()
    for i, item in enumerate(items):
        item["anomaly_pos"] = ["nodule"] if i % 2 else []
    (mimic / "train-processed.json").write_text(json.dumps(items))
    conf = {"conf": {**DATA_CONF, "mimic_cxr_neg_weight": 0.2}, "vl_trans": VL_TRANS,
            "datasets": [{"name": "MIMIC-CXR", "type": "vl", "dir": str(mimic)}]}
    pds = pbuild.build_dataset(conf, MMMMTokenizer.byte_fallback(), tmp_path)
    jds = jbuild.build_dataset(conf, JaxTokenizer.byte_fallback(), tmp_path)
    # the unplanned stream draws from each transform's own generator
    pds.transforms["vl"].R, jds.transforms["vl"].R = (np.random.RandomState(3),
                                                      np.random.RandomState(3))
    np.testing.assert_array_equal(pds.sample_weights[0], jds.sample_weights[0])
    for g, w in zip(pds.stream(6, seed=1), jds.stream(6, seed=1)):
        assert_same(g, w)


def test_io_files_are_byte_equal(tmp_path):
    """``.pt.zst`` and ``.arr.zst`` written by either package are the same
    bytes, and each package reads the other's."""
    rng = np.random.default_rng(0)
    obj = {"a": rng.integers(0, 255, size=(2, 3, 4), dtype=np.uint8),
           "b": [rng.normal(size=(5,)).astype(np.float32), 3]}
    pio.save_pt_zst(obj, tmp_path / "p.pt.zst")
    jio.save_pt_zst(obj, tmp_path / "j.pt.zst")
    assert (tmp_path / "p.pt.zst").read_bytes() == (tmp_path / "j.pt.zst").read_bytes()
    back = pio.load_pt_zst(tmp_path / "j.pt.zst")
    np.testing.assert_array_equal(back["a"], obj["a"])
    np.testing.assert_array_equal(back["b"][0], obj["b"][0])
    assert back["b"][1] == 3
    arr = rng.normal(size=(3, 7)).astype(np.float16)
    pio.save_array_zst(arr, tmp_path / "p.arr.zst")
    jio.save_array_zst(arr, tmp_path / "j.arr.zst")
    assert (tmp_path / "p.arr.zst").read_bytes() == (tmp_path / "j.arr.zst").read_bytes()
    np.testing.assert_array_equal(jio.load_array_zst(tmp_path / "p.arr.zst"), arr)
    np.testing.assert_array_equal(pio.load_array_zst(tmp_path / "j.arr.zst"), arr)
    # the image loader of the card's route: a torch.save'd uint8 .pt volume
    vol = torch.from_numpy(rng.integers(0, 255, size=(1, 2, 3, 4), dtype=np.uint8))
    torch.save(vol, tmp_path / "v.pt")
    np.testing.assert_array_equal(vl.load_image_any(tmp_path / "v.pt"), vol.numpy())
    assert vl.probe_image_shape(tmp_path / "v.pt") == jvl.probe_image_shape(tmp_path / "v.pt")
