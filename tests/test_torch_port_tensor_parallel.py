"""Tensor parallelism over the ``model`` axis in the port, against the JAX
package and against the port's own one-process route, on the CPU.

  (a) The layout, in this process: for meshes (data, model) of (1, 2),
      (2, 4) and (1, 8), at the tiny config (its values, plain and W8A16,
      and its ViT's heads padded by ``pad_attention_heads``) and at the flagship's shapes,
      every process's piece (``local_params``) put back by ``join_pieces``
      rebuilds the leaf, each piece of a fused qkv leaf holds whole heads
      of q, k and v, a process's pieces hold the bytes that
      ``bytes_per_device`` (the JAX package's too) gives for
      ``param_shardings`` at the flagship over (2, 4), and a leaf or a head
      count that the axis does not divide raises and names it. A W4A16
      row piece (repacked, an odd group padded) gives its share of the
      product.
  (b) Serving, one launch of 2 gloo processes, ``model=2``, fp32:
      ``cogvlm_forward``'s logits (the pieces joined) against JAX's under
      ``param_shardings`` on a (1, 2) mesh within 2e-4; greedy generation
      with plain and W8A16 weights token-identical to JAX's sharded
      ``greedy_generate`` (tests/test_tp_serving.py's cases);
      ``generate_grounded`` (greedy, ``spec_draft_len=7``, an int8 cache,
      W8A8 over W8A16 weights) and ``GroundedServer`` token-identical to
      the port's one-process route over the same weights, masks within
      2e-4; a row-parallel W8A8 product (each token's scale over the group)
      against one process's; ``demo --tp 2`` and
      ``predict --tp 2 --device cpu`` print and write what ``--tp 1`` does;
      the vocabulary-parallel argmax on ties across pieces (d).
  (c) Training, one launch of 2 processes: 3 steps of
      ``make_train_step(mesh=(1, 2))`` in each ``vg_mode`` against the
      port's one-process step (losses and gradient norms 1e-5 relative,
      leaves 2 * lr: the row-parallel products sum in another order, and
      Adam moves a leaf whose gradient is rounding noise by about lr either
      way) and, in semantic mode, against JAX's step on a (1, 2)
      mesh (losses 1e-4, gradient norms 1e-5, leaves 2 * lr: PR 16's
      tolerances); every model-replicated trainable leaf equal on both
      processes after every step (``assert_replicated_equal`` over
      ``model``); ``fit`` with ``trainer.mesh_model=2`` against one
      process, then its checkpoint resumed in one process. One launch of 4
      processes takes a (data 2, model 2) step with ZeRO-3 on the pieces.

The tiny model's vocabulary is 268 here (the byte tokenizer's 267 tokens
and one more): a vocabulary the axis does not divide raises.
"""
import contextlib
import csv
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mmmm_tpu.models import MMMMConfig as JaxConfig
from mmmm_tpu.models import MMMMModel
from mmmm_tpu.models.cogvlm import cogvlm_forward as jax_forward
from mmmm_tpu.models.generate import greedy_generate as jax_greedy
from mmmm_tpu.ops.quant import quantize_llm_for_serving as jax_quantize
from mmmm_tpu.parallel import make_mesh as jax_make_mesh
from mmmm_tpu.parallel import sharding as jsharding
from mmmm_tpu.peft import LoraConfig as JaxLoraConfig
from mmmm_tpu.train import OptimizerConfig as JaxOptimizerConfig
from mmmm_tpu.train import make_optimizer as jax_make_optimizer
from mmmm_tpu.train import make_train_step as jax_make_train_step
from mmmm_tpu_torch import MMMMConfig, cli
from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
from mmmm_tpu_torch.models.cogvlm.vit import pad_attention_heads
from mmmm_tpu_torch.models.segvol import SamConfig
from mmmm_tpu_torch.ops.quant import qdot, quantize_int4
from mmmm_tpu_torch.parallel import sharding as psharding
from mmmm_tpu_torch.params import params_from_jax
from mmmm_tpu_torch.peft.lora import flatten
from test_torch_port_models import numpy_params
from test_torch_port_parallel import _map, _shape_tree, start_processes, wait_processes
from test_torch_port_slice import N_VIS, _ground_head, _prompts
from test_torch_port_train import LORA, LR, OPT, STEPS, jax_state0, train_batch

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "conf" / "tiny" / "fit.yaml"
VOCAB = 268
FLAGSHIP = MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())


# ---- (a) the layout, in this process ----

def _probe(path: str, shape, d: int) -> torch.Tensor:
    """A leaf of ``shape`` collapsed to 1 on every dimension but ``d``, whose
    values count along ``d``: cut, it shows which columns each piece took."""
    size = [1] * len(shape)
    size[d] = shape[d]
    return torch.arange(shape[d], dtype=torch.float64).reshape(size)


def _check_tree(flat: dict, model: int, cfg) -> int:
    """Every leaf cut over ``model`` and joined; qkv pieces whole heads.
    Returns the number of leaves that were cut."""
    cut = 0
    for path, leaf in flat.items():
        d = psharding.model_dim(path, leaf.shape, model)
        if d is None:
            continue
        cut += 1
        t = leaf if leaf.device.type != "meta" else _probe(path, leaf.shape, d)
        pieces = [flatten(psharding.local_params({path: t}, ({"model": model}, r), cfg=cfg))[path]
                  for r in range(model)]
        assert all(p.shape[d] * model == t.shape[d] for p in pieces), path
        torch.testing.assert_close(psharding.join_pieces(path, pieces), t, rtol=0, atol=0,
                                   msg=path)
        if psharding.re.match(psharding._HEAD_GROUPED, path) and d == len(leaf.shape) - 1:
            heads = cfg.vision.num_heads if "vision/" in path else cfg.num_attention_heads
            width = t.shape[d] // 3  # q's columns, whole heads of width // heads each
            hd = width // heads
            cols = _probe(path, t.shape, d)
            for r in range(model):
                got = flatten(psharding.local_params({path: cols}, ({"model": model}, r)))[path]
                mine = heads // model
                want = torch.cat([torch.arange(j * width + r * mine * hd,
                                               j * width + (r + 1) * mine * hd)
                                  for j in range(3)]).double()
                assert torch.equal(got.reshape(-1), want), (path, r)
    return cut


@pytest.mark.parametrize("dm", [(1, 2), (2, 4), (1, 8)], ids=lambda m: "data%d-model%d" % m)
@pytest.mark.parametrize("case", ["tiny", "tiny-w8a16", "tiny-padded", "flagship",
                                  "flagship-w8a16"])
def test_pieces_rebuild_every_leaf_with_whole_heads(case, dm):
    data, model = dm
    tiny = case.startswith("tiny")
    cfg = MMMMConfig.tiny(vocab_size=VOCAB) if tiny else FLAGSHIP
    shapes = _shape_tree(cfg, 4 if tiny else 64, case.endswith("w8a16"), bf16=not tiny)
    if tiny:
        gen = torch.Generator().manual_seed(0)
        tree = _map(lambda s: torch.randn(s[0], generator=gen).to(getattr(torch, s[1]))
                    if s[1] != "int8" else torch.randint(-127, 128, s[0], generator=gen,
                                                          dtype=torch.int8), shapes)
        if case == "tiny-padded":
            tree["cogvlm"]["vision"] = pad_attention_heads(tree["cogvlm"]["vision"],
                                                           cfg.vlm.vision.num_heads, 16)
    else:
        tree = _map(lambda s: torch.empty(s[0], dtype=getattr(torch, s[1]), device="meta"),
                    shapes)
    flat = flatten(tree)
    if tiny and model == 8:  # 4 heads do not split over 8 processes
        with pytest.raises(ValueError, match="heads do not split over model=8"):
            psharding.local_params(tree, ({"data": data, "model": model}, 0), cfg=cfg.vlm)
        return
    assert _check_tree(flat, model, cfg.vlm) > 0
    if case == "flagship" and dm == (2, 4):
        sizes = {"data": data, "model": model}
        specs = psharding.param_shardings(tree, sizes)
        mine = sum(psharding._piece(p, t, psharding.model_dim(p, t.shape, model), model, 0)
                   .numel() * t.element_size() for p, t in flat.items())
        jtree = _map(lambda s: jax.ShapeDtypeStruct(s[0], jnp.dtype(s[1])), shapes)
        jbytes = jsharding.bytes_per_device(
            jtree, jsharding.param_shardings(jtree, jax_make_mesh(data=data, model=model)))
        assert mine == psharding.bytes_per_device(tree, specs, sizes) == jbytes


def test_indivisible_leaves_raise_and_name_the_leaf():
    cfg = MMMMConfig.tiny()  # a vocabulary of 128 splits; of 267 it does not
    head = {"cogvlm": {"llm": {"lm_head": torch.zeros(64, 267)}}}
    with pytest.raises(ValueError, match="cogvlm/llm/lm_head: dimension 1"):
        psharding.local_params(head, ({"model": 2}, 0), cfg=cfg.vlm)
    with pytest.raises(ValueError, match="vis_qkv: dimension 2"):
        psharding.local_params({"llm": {"layers": {"vis_qkv": torch.zeros(1, 4, 12)}}},
                               ({"model": 8}, 0))


def test_w4_row_pieces_sum_to_the_product():
    """``down``'s int4 rows over 2 and 4 processes. Over 2, 5 groups of 128
    rows a piece of the (1280, 256) weight, padded to 6 so that each half
    of the packing holds whole groups. Over 4, 320 rows a piece: each holds
    the 3 groups its rows touch (ranks 1 and 3 start 64 rows into a group
    that they share with their neighbour), padded to 4, zero weights outside
    its rows. The pieces' products (x cut to their rows, padded by ``qdot``
    at the piece's front offset) sum to the whole product, and
    ``join_w4`` gives the whole leaf back bit for bit."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((1, 1280, 256), generator=gen) * 0.05
    q = quantize_int4(w)
    tree = {"llm": {"layers": {"lang_mlp": {"down": q}}}}
    x = torch.randn((3, 1280), generator=gen)
    whole = qdot(x, {k: v[0] for k, v in q.items()})
    for n, rows, groups, fronts in ((2, 384, 6, (0, 0)), (4, 256, 4, (0, 64, 0, 64))):
        total, pieces = torch.zeros_like(whole), []
        for r in range(n):
            piece = psharding.local_params(tree, ({"model": n}, r))["llm"]["layers"]["lang_mlp"]
            pieces.append(piece["down"])
            piece = {k: v[0] for k, v in piece["down"].items()}
            assert piece["q4"].shape == (rows, 256) and piece["s4"].shape == (groups, 256)
            assert piece["rows4"].shape == (fronts[r], 1280 // n, 0)
            total += qdot(x[:, r * 1280 // n:(r + 1) * 1280 // n], piece)
        torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
        joined = psharding.join_w4(pieces)
        assert torch.equal(joined["q4"], q["q4"]) and torch.equal(joined["s4"], q["s4"])


def test_w4_pieces_at_the_flagship_over_four_and_the_partial_column_tile():
    """At ``tp=4`` the flagship's W4A16 leaves cut on every rank: ``down``'s
    11,008 rows into pieces of the 22 scale groups (2,816 rows) that each
    rank's 2,752 rows touch, front offsets 0, 64, 0, 64, and ``gate``'s
    columns into pieces 2,752 wide, which K11mma takes (its last 128-column
    tile partial). On the CPU: ``w4_matmul_plain`` at N = 2,752 equals the
    whole product's columns, and ``qdot`` over rank 1's down piece (64 zero
    rows in front) equals the product of its rows."""
    from mmmm_tpu_torch.ops import w4_matmul as w4

    gen = torch.Generator().manual_seed(1)
    tree = {"llm": {"layers": {"lang_mlp": {
        "gate": quantize_int4(torch.randn((1, 512, 11008), generator=gen) * 0.05),
        "down": quantize_int4(torch.randn((1, 11008, 256), generator=gen) * 0.05)}}}}
    x = torch.randn((20, 512), generator=gen)
    xd = torch.randn((20, 11008), generator=gen)
    gate = {k: v[0] for k, v in tree["llm"]["layers"]["lang_mlp"]["gate"].items()}
    down = {k: v[0] for k, v in tree["llm"]["layers"]["lang_mlp"]["down"].items()}
    whole_gate, whole_down = qdot(x, gate), qdot(xd, down)
    total = torch.zeros_like(whole_down)
    for r in range(4):
        mlp = psharding.local_params(tree, ({"model": 4}, r))["llm"]["layers"]["lang_mlp"]
        g = {k: v[0] for k, v in mlp["gate"].items()}
        d = {k: v[0] for k, v in mlp["down"].items()}
        assert g["q4"].shape == (256, 2752) and d["q4"].shape == (1408, 256)
        assert d["rows4"].shape == ((0, 64, 0, 64)[r], 2752, 0)
        assert w4.mma_takes(20, 512, 2752, 128) and w4.route(20, 512, 2752, 128,
                                                            torch.bfloat16) == "K11mma"
        cols = slice(r * 2752, (r + 1) * 2752)
        torch.testing.assert_close(w4.w4_matmul_plain(x, g["q4"], g["s4"]), whole_gate[:, cols],
                                   rtol=1e-5, atol=1e-5)
        part = qdot(xd[:, r * 2752:(r + 1) * 2752], d)
        if r == 1:  # its rows alone, the whole weight's rows 2,752-5,503
            wd = w4.unpack_int4(down["q4"]).float() * down["s4"].repeat_interleave(128, dim=0)
            torch.testing.assert_close(part, xd[:, 2752:5504] @ wd[2752:5504], rtol=1e-5,
                                       atol=1e-5)
        total += part
    torch.testing.assert_close(total, whole_down, rtol=1e-5, atol=1e-4)


# ---- (b) serving and (d) the argmax, one launch of 2 processes ----

SERVE_WORKER = r'''
import contextlib, io, json, sys
from pathlib import Path
import numpy as np
import torch

torch.set_num_threads(1)
from mmmm_tpu_torch import MMMMConfig, cli, generate_grounded, params_from_jax
from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
from mmmm_tpu_torch.models.cogvlm.model import cogvlm_forward
from mmmm_tpu_torch.models.generate import greedy_generate
from mmmm_tpu_torch.models.serving import GroundedServer
from mmmm_tpu_torch.ops.quant import qdot, quantize_int8, quantize_llm_for_serving
from mmmm_tpu_torch.params import _unflatten
from mmmm_tpu_torch.parallel import init_distributed, make_mesh
from mmmm_tpu_torch.parallel.sharding import tp_serving_params
from mmmm_tpu_torch.parallel.tensor import model_parallel, vocab_argmax

tmp, spec = Path(sys.argv[1]), json.loads(sys.argv[2])
assert init_distributed(device="cpu")
rank = torch.distributed.get_rank()
tok = MMMMTokenizer.byte_fallback()
cfg = MMMMConfig.tiny(vocab_size=spec["vocab"])
arrays = dict(np.load(tmp / "serve.npz"))
tree = _unflatten({k[5:]: v for k, v in arrays.items() if k.startswith("tree/")})
ids, tt, pos, lens, img, gimg = (arrays[k] for k in ("ids", "tt", "pos", "lens", "img", "gimg"))
fwd_in = {k: torch.tensor(arrays["fwd_" + k]) for k in ("ids", "tt", "pos", "seg", "img")}
GEN = dict(max_new_tokens=spec["new"], eos_token_id=2, bop_token_id=9, eop_token_id=10,
           image=fwd_in["img"], patch_size=(2, 4, 4), pool_size=(1, 2, 2))
ROUTES = {"greedy": {}, "spec": {"spec_draft_len": 7}, "int8": {"kv_cache_dtype": "int8"}}
SPAN = (1, 1 + spec["n_vis"])
requests = [{"input_ids": ids[i, :lens[i]], "token_type_ids": tt[i, :lens[i]],
             "position_ids": pos[i, :lens[i]], "image": img[i], "grounding_image": gimg[i]}
            for i in range(len(lens))]


def grounded(params, routes=ROUTES, server=True):
    out = {}
    for name, kw in routes.items():
        res = generate_grounded(params, cfg, tok, ids, tt, pos, lens, img, (4, 4, 4),
                                (1, 1, 1), grounding_image=gimg, max_new_tokens=8,
                                max_targets=2, force_grounding=True, vis_span=SPAN,
                                device="cpu", **kw)
        out[name] = (res.tokens, res.masks)
    if not server:
        return out
    server = GroundedServer(params, cfg, tok, patch_size=(4, 4, 4), pool_size=(1, 1, 1),
                            n_vis=spec["n_vis"], n_slots=2, max_new_tokens=8, chunk=4,
                            max_prompt_len=32, max_targets=2, device="cpu")
    out["server"] = server.generate(requests)
    return out


def cli_runs(tp):
    out = {}
    for name, argv in spec["cli"].items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main([a.replace("{tp}", str(tp)) for a in argv])
        out[name] = buf.getvalue()
    return out


W8A8 = {"w8a8": {"w8a8": True, "w8a8_prefill": True}}  # over the W8A16 weights
full = params_from_jax(tree, "cpu", cfg=cfg)
w8 = params_from_jax(tree, "cpu", cfg=cfg)
w8["cogvlm"] = quantize_llm_for_serving(w8["cogvlm"])
whole = {**grounded(full), **grounded(w8, W8A8, server=False)}
pieces, impl = tp_serving_params(full, 2)
assert impl == "auto"
w8, _ = tp_serving_params(w8, 2)
sharded = {**grounded(pieces), **grounded(w8, W8A8, server=False)}
result = {"rank": rank, "cli_tp": cli_runs(2)}
for name in [*ROUTES, *W8A8]:
    result[name] = {"tokens": bool(np.array_equal(whole[name][0], sharded[name][0])),
                    "mask_err": float((whole[name][1] - sharded[name][1]).abs().max())}
result["server"] = {
    "texts": [o["text"] for o in sharded["server"]] == [o["text"] for o in whole["server"]],
    "tokens": all(np.array_equal(a["tokens"], b["tokens"])
                  for a, b in zip(sharded["server"], whole["server"])),
    "mask_err": max(float((a["masks"] - b["masks"]).abs().max())
                    for a, b in zip(sharded["server"], whole["server"]))}

# tests/test_tp_serving.py's and test_parallel_inference.py's cases over the pieces
with torch.inference_mode():
    _, logits = cogvlm_forward(pieces["cogvlm"], cfg.vlm, *(fwd_in[k] for k in
                               ("ids", "tt", "pos", "seg", "img")), (2, 4, 4), (1, 2, 2))
    gen_in = (fwd_in["ids"], fwd_in["tt"], fwd_in["pos"], torch.tensor(arrays["fwd_plen"]))
    plain = greedy_generate(pieces["cogvlm"], cfg.vlm, *gen_in, **GEN)
    quant = greedy_generate(w8["cogvlm"], cfg.vlm, *gen_in, **GEN)

# W8A8's row-parallel product: each process's columns of x and rows of w,
# each token's scale the largest over the group, the partials summed
g = torch.Generator().manual_seed(1)
x = torch.randn((6, 64), generator=g) * torch.linspace(0.1, 4.0, 64)  # the row's max on rank 1
wq = quantize_int8(torch.randn((64, 48), generator=g) * 0.05)
part = qdot(x[:, rank * 32:(rank + 1) * 32], {"q": wq["q"][rank * 32:(rank + 1) * 32],
                                               "s": wq["s"]},
            act_quant=True, group=torch.distributed.group.WORLD)
torch.distributed.all_reduce(part)
one = qdot(x, wq, act_quant=True)
result["w8a8_row"] = float((part - one).abs().max() / one.abs().max())

# (d): ties across the two pieces of 4 columns; the lowest global index wins
ties = torch.tensor([[1., 3., 3., 0., 3., 2., 3., 3.],   # max on both pieces
                     [0., 0., 0., 0., 5., 5., 1., 5.],   # only on piece 1
                     [7., 7., 7., 7., 7., 7., 7., 7.],   # every column
                     [-1., -2., -1., -4., -9., -1., -1., -3.]])
mesh = make_mesh(data=1, model=2, device="cpu")
with model_parallel(mesh.get_group("model")):
    got = vocab_argmax(ties[:, rank * 4:(rank + 1) * 4])
result["ties"] = {"got": got.tolist(), "want": torch.argmax(ties, dim=-1).tolist()}
np.savez(tmp / f"serve_{rank}.npz", logits=logits.numpy(), plain=plain.tokens.numpy(),
         plain_n=plain.num_generated.numpy(), quant=quant.tokens.numpy(),
         quant_n=quant.num_generated.numpy())
(tmp / f"serve_{rank}.json").write_text(json.dumps(result))
'''


def _fwd_inputs(cfg, b=2, s=24, n_vis=10):
    """tests/test_tp_serving.py's batch."""
    rng = np.random.default_rng(0)
    ids = rng.integers(4, cfg.vlm.vocab_size, size=(b, s)).astype(np.int32)
    tt = np.zeros((b, s), np.int32)
    tt[:, 1:1 + n_vis] = 1
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    seg = np.ones((b, s), np.int32)
    plen = np.asarray([s, s - 3], np.int32)
    img = rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32)
    return {"ids": ids, "tt": tt, "pos": pos, "seg": seg, "plen": plen, "img": img}


def _tiny_config(tmp: Path) -> Path:
    """conf/tiny/fit.yaml with a vocabulary of 268."""
    path = tmp / "tiny268.yaml"
    text = TINY.read_text()
    assert "vocab_size: 267" in text
    path.write_text(text.replace("vocab_size: 267", f"vocab_size: {VOCAB}"))
    return path


def _vqa_set(root: Path) -> Path:
    ds = root / "VQA-tp"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        torch.save(torch.from_numpy(rng.integers(0, 255, size=(1, 1, 48, 48), dtype=np.uint8)),
                   ds / f"{i}.pt")
    (ds / "test.json").write_text(json.dumps([
        {"key": "0", "image": ["0.pt"], "vqa": [{"question": "Is it normal?", "answer": "yes"},
                                                {"question": "Any effusion?", "answer": "no"}]},
        {"key": "1", "image": ["1.pt"], "vqa": [{"question": "Where?", "answer": "left"}]}]))
    return ds


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """The 2-process serving run, JAX's sharded forward and greedy
    generations meanwhile, and the CLI commands at ``--tp 1`` in this
    process."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    tok_cfg = MMMMConfig.tiny(vocab_size=VOCAB)
    tree = numpy_params(tok_cfg, 2)
    from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
    _ground_head(tree, MMMMTokenizer.byte_fallback())
    ids, tt, pos, lens, img, gimg = _prompts()
    fwd = _fwd_inputs(tok_cfg)
    np.savez(tmp / "serve.npz", **{f"tree/{k}": v for k, v in flatten(tree).items()},
             ids=ids, tt=tt, pos=pos, lens=lens, img=img, gimg=gimg,
             **{f"fwd_{k}": v for k, v in fwd.items()})
    conf, ds = _tiny_config(tmp), _vqa_set(tmp)
    cli_argv = {
        "demo": ["demo", "-c", str(conf), "--device", "cpu", "--tp", "{tp}",
                 "--max-new-tokens", "6"],
        "predict": ["predict", "-c", str(conf), "--device", "cpu", "--tp", "{tp}", "--task",
                    "vqa", "--dataset-dir", str(ds), "--max-new-tokens", "6", "--batch", "2",
                    "--output", str(tmp / "pred_{tp}.csv")],
        "predict_continuous": ["predict", "-c", str(conf), "--device", "cpu", "--tp", "{tp}",
                               "--task", "vqa", "--dataset-dir", str(ds), "--max-new-tokens",
                               "6", "--batch", "2", "--continuous",
                               "--output", str(tmp / "predc_{tp}.csv")]}
    spec = json.dumps({"vocab": VOCAB, "new": 12, "n_vis": N_VIS, "cli": cli_argv})
    script = tmp / "serve_worker.py"
    script.write_text(SERVE_WORKER)
    procs = start_processes(lambda r: [str(script), str(tmp), spec])
    try:
        ref = jax_serving(tree, fwd)
        one = {}
        for name, argv in cli_argv.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main([a.replace("{tp}", "1") for a in argv])
            one[name] = buf.getvalue()
    finally:
        wait_processes(procs)
    port = [json.loads((tmp / f"serve_{r}.json").read_text()) for r in range(2)]
    arrays = [dict(np.load(tmp / f"serve_{r}.npz")) for r in range(2)]
    return tmp, port, arrays, ref, one


def jax_serving(tree, fwd) -> dict:
    """JAX's forward logits and greedy tokens (plain and W8A16) under
    ``param_shardings`` on a (data 1, model 2) mesh."""
    cfg = JaxConfig.tiny(vocab_size=VOCAB)
    params = jax.tree.map(jnp.asarray, tree)
    mesh = jax_make_mesh(data=1, model=2)
    put = lambda p: jax.device_put(p, jsharding.param_shardings(p, mesh))
    args = tuple(jnp.asarray(fwd[k]) for k in ("ids", "tt", "pos", "seg", "img"))
    logits = jax.jit(lambda p, *a: jax_forward(p, cfg.vlm, *a, (2, 4, 4), (1, 2, 2),
                                               attn_impl="xla")[1])(put(params["cogvlm"]),
                                                                   *args)

    def gen(p, ids, tt, pos, plen, img):
        res = jax_greedy(p["cogvlm"], cfg.vlm, ids, tt, pos, plen, max_new_tokens=12,
                         eos_token_id=2, bop_token_id=9, eop_token_id=10, image=img,
                         patch_size=(2, 4, 4), pool_size=(1, 2, 2), attn_impl="xla")
        return res.tokens, res.num_generated

    gargs = tuple(jnp.asarray(fwd[k]) for k in ("ids", "tt", "pos", "plen", "img"))
    fn = jax.jit(gen)
    plain = fn(put(params), *gargs)
    qparams = dict(params, cogvlm=jax_quantize(dict(params["cogvlm"]), release_originals=False))
    quant = fn(put(qparams), *gargs)
    return {"logits": np.asarray(logits), "plain": tuple(map(np.asarray, plain)),
            "quant": tuple(map(np.asarray, quant))}


def test_tp_forward_and_greedy_match_jax_sharded(serve_runs):
    _, _, arrays, ref, _ = serve_runs
    logits = np.concatenate([a["logits"] for a in arrays], axis=-1)
    np.testing.assert_allclose(logits, ref["logits"], atol=2e-4, rtol=0)
    for key in ("plain", "quant"):
        for a in arrays:
            np.testing.assert_array_equal(a[key], ref[key][0], err_msg=key)
            np.testing.assert_array_equal(a[f"{key}_n"], ref[key][1], err_msg=key)


@pytest.mark.parametrize("route", ["greedy", "spec", "int8", "w8a8", "server"])
def test_tp_grounded_routes_match_one_process(serve_runs, route):
    _, port, _, _, _ = serve_runs
    for r in port:
        assert r[route]["tokens"], route
        assert r[route]["mask_err"] <= 2e-4, r[route]
        if route == "server":
            assert r[route]["texts"]


@pytest.mark.parametrize("command", ["demo", "predict", "predict_continuous"])
def test_tp_commands_print_what_one_process_prints(serve_runs, command):
    tmp, port, _, _, one = serve_runs
    assert port[0]["cli_tp"][command].replace("_2.csv", "_1.csv") == one[command]
    assert port[1]["cli_tp"][command] == ""  # process 1 prints nothing
    if command.startswith("predict"):
        stem = "pred" if command == "predict" else "predc"
        rows = list(csv.DictReader((tmp / f"{stem}_2.csv").open()))
        assert rows == list(csv.DictReader((tmp / f"{stem}_1.csv").open())) and len(rows) == 3


def test_w8a8_row_parallel_scale_is_the_whole_rows(serve_runs):
    """A row-parallel W8A8 product over 2 processes, each token's scale the
    largest over the group, sums to the one-process product (a scale of a
    process's own columns lies 5e-3 from it here)."""
    _, port, _, _, _ = serve_runs
    for r in port:
        assert r["w8a8_row"] <= 1e-6, r["w8a8_row"]


def test_vocab_argmax_ties_take_the_lowest_global_index(serve_runs):
    _, port, _, _, _ = serve_runs
    for r in port:
        assert r["ties"]["got"] == r["ties"]["want"] == [1, 4, 0, 0]


def test_one_process_tp_names_the_variables():
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID"):
        cli.main(["demo", "-c", str(TINY), "--tp", "2", "--device", "cpu"])


# ---- (c) training ----

TRAIN_WORKER = r'''
import json, sys
from pathlib import Path
import numpy as np
import torch

torch.set_num_threads(1)
import mmmm_tpu_torch.parallel.zero as zero
from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, cli, make_optimizer,
                            make_train_step, params_from_jax)
from mmmm_tpu_torch.parallel import (ZeroLeaf, assert_replicated_equal, gather_tree,
                                     init_distributed, make_mesh)
from mmmm_tpu_torch.parallel.sharding import gather_pieces, model_paths
from mmmm_tpu_torch.params import _unflatten
from mmmm_tpu_torch.peft.lora import flatten, split_trainable
from mmmm_tpu_torch.train.step import TrainState, place_state

tmp, spec = Path(sys.argv[1]), json.loads(sys.argv[2])
assert init_distributed(device="cpu")
world = torch.distributed.get_world_size()
zero.FSDP_MIN_SIZE = spec["fsdp_min"]
cfg, opt = MMMMConfig.tiny(), make_optimizer(OptimizerConfig(**spec["opt"]))
lcfg = LoraConfig(**spec["lora"])
saved = dict(np.load(tmp / "state.npz"))
part = lambda prefix: {k[len(prefix):]: v for k, v in saved.items() if k.startswith(prefix)}
mesh = make_mesh(data=world // 2, model=2, device="cpu")
drank = mesh.get_local_rank("data")


def fresh():
    full = params_from_jax(_unflatten({**part("frozen/"), **part("ft/")}), "cpu", cfg=cfg)
    ft, frozen = split_trainable(full)
    lora = _unflatten({k: torch.tensor(v) for k, v in part("lora/").items()})
    trainable = {"lora": lora, "ft": ft}
    for t in flatten(trainable).values():
        t.requires_grad_(True)
    return TrainState(0, trainable, opt.init(flatten(trainable))), frozen


result = {}
for mode in spec["modes"]:
    batch = dict(np.load(tmp / f"batch_{mode}.npz"))
    batch.update(patch_size=(4, 4, 4), pool_size=(1, 1, 1))
    k = batch["labels"].shape[0] // (world // 2)
    local = {n: v[drank * k:(drank + 1) * k] if isinstance(v, np.ndarray) else v
             for n, v in batch.items()}
    kw = dict(vg_mode=mode, attn_impl="pallas", remat=True, dropout_seed=None,
              vis_span="auto", device="cpu")
    s1, f1 = fresh()
    one = make_train_step(cfg, opt, lcfg, **kw)
    s2, f2 = place_state(*fresh(), mesh)
    two = make_train_step(cfg, opt, lcfg, mesh=mesh, **kw)
    logs1, logs2, replicated = [], [], 0
    for i in range(spec["steps"]):
        s1, l1 = one(s1, f1, batch)
        s2, l2 = two(s2, f2, local)
        logs1.append({n: float(v) for n, v in l1.items()})
        logs2.append({n: float(v) for n, v in l2.items()})
        flat = flatten(s2.trainable)
        cut = model_paths(flat)
        rep = {p: v for p, v in flat.items() if p not in cut and not isinstance(v, ZeroLeaf)}
        assert_replicated_equal({"trainable": rep, "step": torch.tensor(s2.step)}, mesh,
                                axis="model")
        replicated = len(rep)
    leaves = flatten(gather_pieces(gather_tree(s2.trainable), mesh.get_group("model")))
    ref = flatten(s1.trainable)
    result[mode] = {"logs_one": logs1, "logs_tp": logs2, "replicated": replicated,
                    "cut": len(cut), "zero": sum(isinstance(v, ZeroLeaf) for v in flat.values()),
                    "leaf_err": max(float((leaves[p] - ref[p]).abs().max()) for p in ref)}
    if torch.distributed.get_rank() == 0:
        np.savez(tmp / f"leaves_{mode}_{world}.npz",
                 **{p: t.detach().numpy() for p, t in leaves.items()})
if spec["fit"]:
    cli.main(spec["fit"])
(tmp / f"train_{world}_{torch.distributed.get_rank()}.json").write_text(json.dumps(result))
'''

MODES = ("none", "semantic", "instance")


def _fit_args(out_dir, datasets: str, max_steps: int, extra=(), resume=True) -> list[str]:
    return ["fit", "-c", str(TINY), "--device", "cpu", *([] if resume else ["--no-resume"]),
            f"trainer.out_dir={out_dir}", datasets,
            "data.vl_trans={max_tokens: 64, max_tokens_z: 4}", "trainer.bf16_vlm=false",
            "trainer.frozen_vlm_bf16=false", "trainer.ckpt_every=2",
            f"trainer.max_steps={max_steps}", "optimizer.max_steps=4",
            f"model.vlm.vocab_size={VOCAB}", *extra]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The 2-process (1, 2) steps and fit, the 4-process (2, 2) step, JAX's
    semantic step on a (1, 2) mesh and the one-process fit meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_train")
    state, frozen = jax_state0(bf16=False)
    flat = {f"lora/{p}": np.asarray(v) for p, v in flatten(state.trainable["lora"]).items()}
    flat.update({f"ft/{p}": np.asarray(v) for p, v in flatten(state.trainable["ft"]).items()})
    flat.update({f"frozen/{p}": np.asarray(v) for p, v in flatten(frozen).items()})
    np.savez(tmp / "state.npz", **flat)
    for mode in MODES:
        np.savez(tmp / f"batch_{mode}.npz",
                 **{k: v for k, v in train_batch(mode).items() if isinstance(v, np.ndarray)})
    chip_smoke.write_vl_dataset(tmp / "VLSet", 3, (1, 8, 32, 32), report_chars=120, seed=1)
    datasets = f"data.datasets=[{{name: VLSet, type: vl, dir: {tmp / 'VLSet'}}}]"
    one, two = tmp / "fit_one", tmp / "fit_two"
    script = tmp / "train_worker.py"
    script.write_text(TRAIN_WORKER)
    base = {"opt": OPT, "lora": {**LORA, "dropout": 0.0}, "steps": STEPS}
    spec2 = json.dumps({**base, "modes": MODES, "fsdp_min": 1 << 16,
                        "fit": _fit_args(two, datasets, 2, ["trainer.mesh_model=2"],
                                         resume=False)})
    spec4 = json.dumps({**base, "modes": ["semantic"], "fsdp_min": 1, "fit": None})
    procs = start_processes(lambda r: [str(script), str(tmp), spec2])
    procs += start_processes(lambda r: [str(script), str(tmp), spec4], n=4)
    try:
        ref = jax_semantic_steps(state, frozen)
        cli.main(_fit_args(one, datasets, 2, resume=False))
    finally:
        wait_processes(procs)
    cli.main(_fit_args(one, datasets, 3))
    cli.main(_fit_args(two, datasets, 3))
    read = lambda name: json.loads((tmp / name).read_text())
    port = {2: [read(f"train_2_{r}.json") for r in range(2)],
            4: [read(f"train_4_{r}.json") for r in range(4)]}
    return tmp, port, ref, one, two


def jax_semantic_steps(state0, frozen) -> dict:
    step = jax_make_train_step(
        MMMMModel(JaxConfig.tiny()), jax_make_optimizer(JaxOptimizerConfig(**OPT)),
        JaxLoraConfig(**LORA), vg_mode="semantic", attn_impl="xla", remat=True,
        mesh=jax_make_mesh(data=1, model=2), donate=False, dropout_seed=None, vis_span="auto")
    batch = {**{k: v for k, v in train_batch("semantic").items() if isinstance(v, np.ndarray)},
             "patch_size": (4, 4, 4), "pool_size": (1, 1, 1)}
    jstate, logs = state0, []
    for _ in range(STEPS):
        jstate, log = step(jstate, frozen, batch)
        logs.append({k: float(v) for k, v in log.items()})
    return {"logs": logs, "leaves": {p: np.asarray(v) for p, v in
                                     flatten(jax.device_get(jstate.trainable)).items()}}


@pytest.mark.parametrize("world,mode", [(2, "none"), (2, "semantic"), (2, "instance"),
                                        (4, "semantic")])
def test_tp_step_matches_one_process_and_keeps_replicas_equal(train_runs, world, mode):
    _, port, _, _, _ = train_runs
    runs = [r[mode] for r in port[world]]
    assert all(r["logs_tp"] == runs[0]["logs_tp"] for r in runs)
    assert runs[0]["cut"] > 0 and runs[0]["replicated"] > 0
    assert (runs[0]["zero"] > 0) == (world == 4)  # ZeRO over data on the pieces
    for i, (got, want) in enumerate(zip(runs[0]["logs_tp"], runs[0]["logs_one"])):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f"{mode} step {i + 1} {key}")
    assert max(r["leaf_err"] for r in runs) <= 2 * LR


def test_tp_step_matches_jax_tensor_parallel_step(train_runs):
    tmp, port, ref, _, _ = train_runs
    got_logs = port[2][0]["semantic"]["logs_tp"]
    for i, (got, want) in enumerate(zip(got_logs, ref["logs"])):
        assert set(got) == set(want)
        for key in want:
            tol = 1e-5 if key == "grad_norm" else 1e-4
            np.testing.assert_allclose(got[key], want[key], rtol=tol, err_msg=f"{i + 1} {key}")
    leaves = np.load(tmp / "leaves_semantic_2.npz")
    assert set(leaves.files) == set(ref["leaves"])
    for p in leaves.files:
        np.testing.assert_allclose(leaves[p], ref["leaves"][p], rtol=0, atol=2 * LR, err_msg=p)


def test_fit_over_the_model_axis_matches_one_process_and_resumes_in_one(train_runs):
    _, _, _, one, two = train_runs
    read = lambda d: [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
    m1, m2 = read(one), read(two)
    assert [m["step"] for m in m2] == [1, 2, 3] == [m["step"] for m in m1]
    for a, b in zip(m1, m2):
        for k in a:
            if k != "steps_per_sec":
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=f"{a['step']} {k}")
    for name in ("trainable", "opt_state"):
        a = flatten(torch.load(one / "ckpt" / "2" / f"{name}.pt", weights_only=True))
        b = flatten(torch.load(two / "ckpt" / "2" / f"{name}.pt", weights_only=True))
        assert set(a) == set(b)
        for p in a:
            if isinstance(a[p], torch.Tensor):
                assert a[p].shape == b[p].shape, p
                torch.testing.assert_close(b[p], a[p], rtol=0, atol=1e-5, msg=p)
    # both resumed to step 3 in one process: the same whole adapter
    a, b = np.load(one / "adapter.npz"), np.load(two / "adapter.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
