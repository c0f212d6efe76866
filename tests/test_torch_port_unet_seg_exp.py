"""The 3-D UNet and the segmentation ablation (``seg-exp``) of the port
against the JAX package on the CPU: ``unet_forward`` and its gradients at
odd and even sizes over ``unet_params_from_jax``; three steps of
``run_seg_exp`` (UNet arm) against the JAX script's step under
``optax.adamw(cosine_decay_schedule)`` over the same patches; the SAM arm's
DiceFocal loss and gradients at a tiny ``SamConfig``; and the ``seg-exp``
command with both arms, from flags and from ``-c conf/seg-exp/*.yaml``
with overrides.

Tolerances: outputs, losses and gradients within 1e-4 relative to each
tensor's largest entry (fp32 convolutions, norms and resizes summed in
another order).
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmmm_tpu.models.segvol import DiceFocalLoss as JDiceFocal
from mmmm_tpu.models.segvol import SamConfig as JSamConfig
from mmmm_tpu.models.segvol import init_sam_params as j_init_sam
from mmmm_tpu.models.segvol import sam_forward as j_sam_forward
from mmmm_tpu.models.unet import init_unet_params as j_init_unet
from mmmm_tpu.models.unet import unet_forward as j_unet_forward
from mmmm_tpu_torch import cli
from mmmm_tpu_torch.models.unet import init_unet_params, unet_forward
from mmmm_tpu_torch.params import _flatten, map_tree, unet_params_from_jax
from mmmm_tpu_torch.train.seg_exp import build_model, run_seg_exp, seg_loss

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_close(got, ref, rtol=1e-4, scale=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = rtol * (np.abs(ref).max() if scale is None else scale) + 1e-12
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def _grads_close(tgrads: dict, jgrads, rtol=1e-4):
    ref = _flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(ref) == set(tgrads)
    top = max(np.abs(r).max() for r in ref.values())
    for k, g in tgrads.items():
        m = np.abs(ref[k]).max()
        _rel_close(g.numpy(), ref[k], rtol, scale=m if m > 1e-5 * top else top)


@pytest.mark.parametrize("shape", [(1, 1, 5, 12, 10), (2, 2, 8, 16, 16)])
def test_unet_forward_and_gradients_match_jax(shape):
    rng = np.random.default_rng(0)
    c_in = shape[1]
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: j_init_unet(k, c_in, 3, channels=(4, 8, 16)))(jax.random.PRNGKey(0)))
    image = rng.normal(size=shape).astype(np.float32)
    ct = rng.normal(size=(shape[0], 3, *shape[2:])).astype(np.float32)
    def jloss(p, x):
        out = j_unet_forward(p, x)
        return (out * ct).sum(), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams, jnp.asarray(image))
    params = unet_params_from_jax(jparams, "cpu")
    flat = _flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    out = unet_forward(params, torch.from_numpy(image))
    assert out.shape == (shape[0], 3, *shape[2:])
    _rel_close(out.detach().numpy(), jout)
    loss = (out * torch.from_numpy(ct)).sum()
    _rel_close(loss.item(), float(jl))
    _grads_close(dict(zip(flat, torch.autograd.grad(loss, list(flat.values())))), jg)


def test_unet_init_and_params_checks():
    jshapes = jax.eval_shape(lambda: j_init_unet(jax.random.PRNGKey(0), 2, 3, (4, 8, 16)))
    got = _flatten(init_unet_params(2, 3, (4, 8, 16), seed=0, device="cpu"))
    assert ({k: tuple(v.shape) for k, v in got.items()}
            == {k: tuple(v.shape) for k, v in _flatten(jshapes).items()})
    tree = _numpy_tree(init_unet_params(1, 2, (4, 8), seed=0, device="cpu"))
    tree["dec"][0]["block"]["conv1"]["w"] = np.zeros((3, 3, 3, 8, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        unet_params_from_jax(tree, "cpu")
    tree = _numpy_tree(init_unet_params(1, 2, (4, 8), seed=0, device="cpu"))
    tree["head"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="not consumed"):
        unet_params_from_jax(tree, "cpu")


def _cases(n=3, shape=(8, 24, 20), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.random((1, *shape)).astype(np.float32)
        m = np.zeros((2, *shape), bool)
        m[0, 2:6, 4:14, 5:12] = True
        m[1, 1:4, 12:20, 2:9] = True
        img[0][m[0]] += 0.5
        out.append((img, m))
    return out


def test_run_seg_exp_unet_matches_optax():
    """Three UNet steps of ``run_seg_exp`` from the JAX init against the JAX
    script's step (``DiceFocalLoss().per_channel`` mean, ``optax.adamw(
    cosine_decay_schedule(lr, steps), weight_decay)``) over the same
    foreground-biased patches: each step's loss within 1e-4 relative."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import seg_exp as jseg
    finally:
        sys.path.pop(0)
    cfg = {"model": "unet", "classes": ["liver", "spleen"], "steps": 3, "batch": 2,
           "patch": [8, 16, 16], "lr": 1e-3, "weight_decay": 5e-2, "channels": [4, 8, 16],
           "val_frac": 0.34, "seed": 0, "log_every": 100}
    cases = _cases()
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: j_init_unet(k, 1, 2, channels=(4, 8, 16)))(jax.random.PRNGKey(0)))
    losses = []
    res = run_seg_exp(cfg, cases, device="cpu", params=unet_params_from_jax(jparams, "cpu"),
                      log=lambda m: None, on_step=lambda it, l: losses.append(l.item()))
    assert res["model"] == "unet" and set(res["dice"]) == {"liver", "spleen"}
    assert 0.0 <= res["mean_dice"] <= 1.0

    tx = optax.adamw(optax.cosine_decay_schedule(cfg["lr"], cfg["steps"]),
                     weight_decay=cfg["weight_decay"])
    loss_fn = JDiceFocal()

    @jax.jit
    def step(params, opt_state, image, target):
        def loss(p):
            return loss_fn.per_channel(j_unet_forward(p, image).astype(jnp.float32),
                                       target).mean()

        l, g = jax.value_and_grad(loss)(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, l

    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    opt_state = tx.init(params)
    rng = np.random.default_rng(cfg["seed"])
    train = cases[1:]
    ref = []
    for _ in range(cfg["steps"]):
        imgs, tgts = [], []
        for _ in range(cfg["batch"]):
            img, msk = train[rng.integers(len(train))]
            pi, pm = jseg.sample_patch(rng, img, msk, tuple(cfg["patch"]))
            imgs.append(pi)
            tgts.append(pm.astype(np.float32))
        params, opt_state, l = step(params, opt_state, jnp.asarray(np.stack(imgs)),
                                    jnp.asarray(np.stack(tgts)))
        ref.append(float(l))
    np.testing.assert_allclose(losses, ref, rtol=1e-4)


def test_sam_arm_loss_and_gradients_match_jax():
    """The SAM arm's forward (``sam_forward`` over one learned prompt a
    class, upsampled to the patch) and DiceFocal loss at a tiny
    ``SamConfig``, the JAX init bridged leaf for leaf."""
    kw = dict(in_channels=1, embed_dim=32, encoder_num_layers=2, encoder_num_heads=4,
              patch_size=(4, 8, 8), pos_embed_shape=(2, 2, 2), num_instances=3,
              decoder_mlp_dim=64)
    jcfg = JSamConfig(**kw)
    key = jax.random.PRNGKey(0)
    jsam = jax.jit(lambda k: j_init_sam(k, jcfg))(key)
    prompts = np.random.default_rng(1).normal(size=(2, 32)).astype(np.float32) * 0.02
    jparams = jax.tree_util.tree_map(np.asarray, {"sam": jsam, "prompts": prompts})
    rng = np.random.default_rng(2)
    image = rng.random((2, 1, 8, 16, 16)).astype(np.float32)
    target = (rng.random((2, 2, 8, 16, 16)) > 0.7).astype(np.float32)

    def jloss(p):
        pr = jnp.broadcast_to(p["prompts"][None], (2, *p["prompts"].shape))
        masks, _ = j_sam_forward(p["sam"], jcfg, jnp.asarray(image), jcfg.patch_size, pr)
        return JDiceFocal().per_channel(masks.astype(jnp.float32), jnp.asarray(target)).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    cfg = {"model": "sam", "classes": ["a", "b"], "seed": 0, "sam": {
        k: list(v) if isinstance(v, tuple) else v for k, v in kw.items() if k != "in_channels"}}
    _, forward = build_model(cfg, 1, torch.device("cpu"))
    params = map_tree(lambda a: torch.from_numpy(np.array(a, np.float32)), jparams)
    flat = _flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss = seg_loss(forward(params, torch.from_numpy(image)), torch.from_numpy(target))
    _rel_close(loss.item(), float(jl))
    # the prompt encoder's point, box and mask leaves take no part: JAX
    # gives them zero gradients, autograd none
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    _grads_close({k: torch.zeros_like(t) if g is None else g
                  for (k, t), g in zip(flat.items(), grads)}, jg)


def _numpy_tree(tree):
    return map_tree(lambda t: t.numpy(), tree)


def _write_dataset(root: Path, n_cases=3):
    """A processed segmentation dataset (as tests/test_seg_exp.py writes it)."""
    from mmmm_tpu_torch.data.sparse import Sparse, Target
    from mmmm_tpu_torch.utils import save_pt_zst

    rng = np.random.default_rng(0)
    for k in range(n_cases):
        case = root / "data" / f"c{k}"
        case.mkdir(parents=True)
        img = np.zeros((1, 8, 32, 32), np.uint8)
        mask = np.zeros((1, 8, 32, 32), bool)
        mask[0, 2:6, 8:24, 8:24] = True
        img[0][mask[0]] = 200
        img = img + rng.integers(0, 20, img.shape).astype(np.uint8)
        save_pt_zst(img, case / "images.pt.zst")
        save_pt_zst(mask, case / "masks.pt.zst")
        sp = Sparse(
            spacing=np.ones(3), shape=np.asarray([8, 32, 32]), modalities=["CT"],
            mean=np.asarray([50.0], np.float32), std=np.asarray([60.0], np.float32),
            targets={"anatomy": [Target(name="spleen", semantic=True, index_offset=(0, 1))],
                     "anomaly": []},
            neg_targets={"anatomy": [], "anomaly": []}, complete_anomaly=False,
        )
        (case / "sparse.json").write_bytes(sp.to_json())


@pytest.mark.parametrize("how", ["unet-flags", "unet-config", "sam-config"])
def test_seg_exp_command(tmp_path, capsys, how):
    _write_dataset(tmp_path)
    out = tmp_path / "res.json"
    common = ["--data", str(tmp_path), "--classes", "spleen", "--steps", "2", "--batch", "1",
              "--patch", "8", "32", "32", "--out", str(out), "--log-every", "1",
              "--device", "cpu"]
    if how == "unet-flags":
        argv = ["--model", "unet", "--channels", "4", "8", *common]
    elif how == "unet-config":
        argv = ["-c", str(ROOT / "conf" / "seg-exp" / "unet.yaml"), "--channels", "4", "8",
                *common]
    else:
        argv = ["-c", str(ROOT / "conf" / "seg-exp" / "sam.yaml"), *common]
    args = cli.parse_args(["seg-exp", *argv])
    cfg = cli.seg_exp_config(args)
    assert cfg["steps"] == 2 and cfg["batch"] == 1 and cfg["patch"] == [8, 32, 32]
    if how == "unet-config":
        assert cfg["lr"] == 3e-4 and cfg["channels"] == [4, 8]
    if how == "sam-config":
        assert cfg["lr"] == 1e-4 and cfg["sam"]["patch_size"] == [8, 16, 16]
    res = args.func(args)
    assert json.loads(out.read_text()) == res
    assert res["model"] == how.split("-")[0] and set(res["dice"]) == {"spleen"}
    assert 0.0 <= res["mean_dice"] <= 1.0
    printed = capsys.readouterr().out
    assert "2 train / 1 val cases" in printed and "[1] loss=" in printed


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mmmm_tpu_torch.models.detector import DetectorConfig, init_detector_params
    from mmmm_tpu_torch.train.detector import infer_images, train_detector

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_unet_params(1, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_detector_params(DetectorConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_seg_exp({"model": "unet", "classes": ["a"], "val_frac": 0.5}, _cases(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_detector(DetectorConfig(), [], steps=1, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_images({}, DetectorConfig(), [], Path("unused"))
