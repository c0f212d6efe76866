"""The port's ``detector-train`` and ``detector-infer`` commands on the CPU
over a synthetic processed VinDr-CXR directory (written as
tests/test_detector.py writes it): the checkpoint, the mAP@0.5 line and the
``{stem}_box.json`` contract, and the port's ``params.npz`` read by the JAX
package's ``scripts/data/detector.py infer``, whose boxes must be the
port's within 1e-3 px (fp32 forwards in another order of sums, boxes
scaled to a few hundred pixels). The reverse direction, a checkpoint of the
JAX script's ``train`` read by the port, is in
tests/test_torch_port_detector_jax_ckpt.py.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmmm_tpu_torch import cli
from mmmm_tpu_torch.models.detector import VINDR_CLASSES

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--size", "64", "--layers", "1", "--queries", "8"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_processed(root: Path, n: int = 4) -> Path:
    """A processed VinDr-CXR layout of ``n`` cases (``images.pt.zst``,
    ``sparse.json``) with two boxed findings each."""
    from mmmm_tpu_torch.data.sparse import Sparse, Target
    from mmmm_tpu_torch.utils import save_pt_zst

    rng = np.random.default_rng(0)
    for k in range(n):
        case = root / "proc" / "data" / f"case{k}"
        case.mkdir(parents=True)
        img = rng.integers(0, 40, (1, 1, 64, 80)).astype(np.uint8)
        img[0, 0, 8:28, 16:48] = 200
        img[0, 0, 40:52, 56:72] = 120
        save_pt_zst(img, case / "images.pt.zst")
        sp = Sparse(
            spacing=np.ones(3), shape=np.asarray([1, 64, 80]), modalities=["X-ray"],
            mean=np.asarray([30.0], np.float32), std=np.asarray([60.0], np.float32),
            targets={"anomaly": [
                Target("cardiomegaly", False, boxes=np.asarray([[0, 8, 16, 1, 28, 48]], np.int64)),
                Target("lung nodule", False, boxes=np.asarray([[0, 40, 56, 1, 52, 72]], np.int64)),
            ], "anatomy": []},
            neg_targets={"anatomy": [], "anomaly": []}, complete_anomaly=True,
        )
        (case / "sparse.json").write_bytes(sp.to_json())
    return root / "proc"


def write_studies(root: Path) -> Path:
    """Tagged studies: a PNG and a ``.pt.zst`` image, and a tags JSON."""
    from PIL import Image

    from mmmm_tpu_torch.utils import save_pt_zst

    img_dir = root / "images"
    img_dir.mkdir()
    arr = np.random.default_rng(1).integers(0, 40, (64, 80)).astype(np.uint8)
    arr[8:28, 16:48] = 180
    arr[40:52, 56:72] = 110
    Image.fromarray(arr).save(img_dir / "study1.png")
    save_pt_zst(arr[None, None], img_dir / "study2.pt.zst")
    tags = [{"image": ["study1.png"], "tags": [{"target": "cardiomegaly"},
                                               {"target": "lung nodule"}]},
            {"image": ["study2.pt.zst", "missing.png"],
             "tags": [{"target": "cardiomegaly"}, {"target": "not a vindr class"}]}]
    (root / "tags.json").write_text(json.dumps(tags))
    return root / "tags.json"


def infer_args(ckpt, tags, out) -> list:
    return ["--ckpt", str(ckpt), "--tags", str(tags), "--images", str(tags.parent / "images"),
            "--out", str(out), *SMALL]


def assert_boxes_close(a: Path, b: Path) -> None:
    for name in ("study1_box.json", "study2_box.json"):
        ja, jb = json.loads((a / name).read_text()), json.loads((b / name).read_text())
        assert ja.keys() == jb.keys(), name
        for k in ja:
            np.testing.assert_allclose(np.asarray(ja[k]), np.asarray(jb[k]), atol=1e-3, rtol=0)


def test_detector_train_then_infer(tmp_path, capsys):
    proc = write_processed(tmp_path)
    ckpt = tmp_path / "ckpt"
    args = cli.parse_args(
        ["detector-train", "--data", str(proc), "--out", str(ckpt), "--steps", "2",
         "--batch", "2", "--log-every", "1", "--eval-frac", "0.25", "--device", "cpu", *SMALL])
    result = args.func(args)
    out = capsys.readouterr().out
    assert "4 cases; classes=21" in out and "[0] loss=" in out and "[1] loss=" in out
    assert "mAP@0.5 (held-out 1) = " in out and 0.0 <= result["map"] <= 1.0
    assert len(result["losses"]) == 2 and np.isfinite(result["losses"]).all()
    from mmmm_tpu_torch.train.checkpoint import load_params

    state = load_params(ckpt)
    assert {"steps", "batch", "size", "layers", "queries", "lr"} <= set(state["cfg"])
    assert "device" not in state["cfg"]
    assert isinstance(state["params"]["encoder"], list)

    tags = write_studies(tmp_path)
    out_dir = tmp_path / "boxes"
    args = cli.parse_args(["detector-infer", *infer_args(ckpt, tags, out_dir), "--device", "cpu"])
    assert args.func(args) == 2
    for name, w, h in (("study1_box.json", 80, 64), ("study2_box.json", 80, 64)):
        boxes = json.loads((out_dir / name).read_text())
        assert set(boxes) <= set(VINDR_CLASSES)
        for bxs in boxes.values():
            for b in bxs:
                assert len(b) == 4 and 0 <= b[0] <= b[2] <= w and 0 <= b[1] <= b[3] <= h
    assert "not a vindr class" not in json.loads((out_dir / "study2_box.json").read_text())

    # the JAX script reads the port's checkpoint and writes the same boxes
    sys.path.insert(0, str(ROOT / "scripts" / "data"))
    try:
        import detector as jax_det_cli
    finally:
        sys.path.pop(0)
    jax_out = tmp_path / "boxes_jax"
    jax_det_cli.main(["infer", *infer_args(ckpt, tags, jax_out)])
    assert_boxes_close(out_dir, jax_out)


def test_detector_commands_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = write_processed(tmp_path, n=2)
    args = cli.parse_args(["detector-train", "--data", str(proc), "--out", str(tmp_path / "c"),
                           "--steps", "1", *SMALL])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        args.func(args)
