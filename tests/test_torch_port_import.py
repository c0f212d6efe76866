"""The port's checkpoint importers (``train/import_torch.py``) against the JAX
package's, on the synthetic HF CogVLM and SegVol state dicts of
``tests/test_import_torch.py``: the JAX importers' trees merged over the
port's fresh init (as numpy: the JAX init is only slower to make) and
bridged by ``params_from_jax``, leaf by leaf against the port's importers
merged over the same init. Copied leaves (transposes, stacks, reshapes, the
vocabulary extension, the collapsed LayerNorm stats, the fresh heads) are
bit-equal; the resampled ones (the ViT's position grid and patch conv, the
SAM encoder's) within 1e-6."""
import numpy as np
import pytest
import torch

from mmmm_tpu.models.cogvlm import CogVLMConfig as JaxCogVLMConfig
from mmmm_tpu.models.segvol import SamConfig as JaxSamConfig
from mmmm_tpu.train import import_torch as jimp
from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
from mmmm_tpu_torch.models.mmmm import MMMMConfig
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.params import _flatten, init_params, params_from_jax
from mmmm_tpu_torch.train import import_torch as pimp
from test_import_torch import _fake_cogvlm_sd, _fake_segvol_sd

PT_PATCH, PT_POS = (2, 4, 4), (2, 2, 2)
RESAMPLED = {"cogvlm/vision/patch/pos", "cogvlm/vision/patch/proj_w",
             "sam/encoder/patch/proj_w", "sam/encoder/patch/pos",
             "isam/encoder/patch/proj_w", "isam/encoder/patch/pos"}


@pytest.fixture(scope="module")
def trees():
    """(port tree, bridged JAX tree, the port's imported paths, its fresh tree)."""
    cfg = MMMMConfig(vlm=CogVLMConfig.tiny(vocab_size=100), sam=SamConfig.tiny())
    jvlm, jsam = JaxCogVLMConfig.tiny(vocab_size=100), JaxSamConfig.tiny()
    vlm_sd = _fake_cogvlm_sd(jvlm, base_vocab=92)
    sam_sd = _fake_segvol_sd(jsam, pt_patch=PT_PATCH, pt_pos=PT_POS)
    kw = dict(pt_in_channels=1, pt_patch_size=PT_PATCH, pt_pos_embed_shape=PT_POS)

    fresh = init_params(cfg, dtype=torch.float32, device="cpu")
    as_np = lambda t: {k: as_np(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}
    jfresh = as_np(fresh)
    fresh_tokens = jfresh["isam"]["decoder"]["mask_tokens"]
    jtree = {
        "cogvlm": jimp.merge_imported(jfresh["cogvlm"], jimp.import_cogvlm(vlm_sd, jvlm)),
        "sam": jimp.merge_imported(jfresh["sam"], jimp.import_segvol_sam(sam_sd, jsam, **kw)),
        "isam": jimp.merge_imported(jfresh["isam"], jimp.import_segvol_sam(
            sam_sd, jsam, instance=True, fresh_mask_tokens=fresh_tokens, **kw)),
        "vg_proj": jfresh["vg_proj"],
    }
    imported = {
        "cogvlm": pimp.import_cogvlm(vlm_sd, cfg.vlm),
        "sam": pimp.import_segvol_sam(sam_sd, cfg.sam, **kw),
        "isam": pimp.import_segvol_sam(sam_sd, cfg.sam, instance=True,
                                       fresh_mask_tokens=fresh_tokens, **kw),
    }
    port = pimp.merge_imported(fresh, imported)
    bridged = params_from_jax(jtree, "cpu", cfg=cfg)
    return port, bridged, set(_flatten(imported)), fresh


def test_import_covers_the_jax_importers_leaves(trees):
    port, bridged, paths, fresh = trees
    assert _flatten(port).keys() == _flatten(fresh).keys()
    b = _flatten(bridged)
    for path, t in _flatten(port).items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert tuple(t.shape) == tuple(b[path].shape), path
        if path not in paths:  # a fresh leaf on both sides
            assert torch.equal(t, b[path]), path
    assert RESAMPLED < paths
    # heads the checkpoints lack keep the fresh init
    for path in ("isam/box_head/w1", "isam/disc_head/w2", "sam/prompt/mask_down/conv1_w"):
        assert path not in paths and torch.equal(_flatten(port)[path], _flatten(fresh)[path])


@pytest.mark.parametrize("group", ["cogvlm/llm", "cogvlm/vision", "sam", "isam"])
def test_imported_leaves_match_jax(trees, group):
    """Every imported leaf of the group: bit-equal, resampled within 1e-6."""
    port, bridged, paths, _ = trees
    p, b = _flatten(port), _flatten(bridged)
    checked = 0
    for path in sorted(x for x in paths if x.startswith(group + "/")):
        if path in RESAMPLED:
            np.testing.assert_allclose(p[path].numpy(), b[path].numpy(), rtol=0, atol=1e-6,
                                       err_msg=path)
        else:
            assert torch.equal(p[path], b[path]), path
        checked += 1
    assert checked >= 6


def test_vocab_extension_and_mask_tokens(trees):
    """The 8 added vocabulary rows are the base rows' mean; the mask-token
    rows past the checkpoint's keep the fresh table's."""
    port, _, _, fresh = trees
    emb = port["cogvlm"]["llm"]["embed_tokens"]
    torch.testing.assert_close(emb[92:], emb[:92].mean(0, keepdim=True).expand(8, -1),
                               rtol=0, atol=1e-6)
    mt = port["isam"]["decoder"]["mask_tokens"]
    assert mt.shape[0] == SamConfig.tiny().num_mask_tokens
    assert torch.equal(mt[2:], fresh["isam"]["decoder"]["mask_tokens"][2:])
    assert not port["sam"]["decoder"]["mask_tokens"][2:].any()  # zeros without a fresh table


@pytest.mark.parametrize("mode", ["mean", "center"])
@pytest.mark.parametrize("depth", [3, 4])
def test_inflate_conv_z_matches_jax(mode, depth):
    w2 = np.random.default_rng(2).normal(size=(4, 3, 5, 5)).astype(np.float32)
    got = pimp.inflate_conv_z(torch.from_numpy(w2), depth, mode)
    np.testing.assert_array_equal(got.numpy(), jimp.inflate_conv_z(w2, depth, mode))
    torch.testing.assert_close(got.sum(2), torch.from_numpy(w2), rtol=0, atol=1e-6)


def test_merge_imported_rejects_a_shape_mismatch():
    fresh = {"a": {"w": torch.zeros(3, 4)}, "b": torch.ones(2)}
    with pytest.raises(ValueError, match="shape mismatch at w"):
        pimp.merge_imported(fresh, {"a": {"w": np.zeros((4, 3))}})


def test_merge_imported_takes_the_fresh_dtype():
    fresh = {"w": torch.zeros(2, 3, dtype=torch.bfloat16), "keep": torch.ones(1)}
    src = np.random.default_rng(0).normal(size=(2, 3))
    out = pimp.merge_imported(fresh, {"w": src})
    assert out["w"].dtype == torch.bfloat16 and out["keep"] is fresh["keep"]
    assert torch.equal(out["w"], torch.from_numpy(src).to(torch.bfloat16))
