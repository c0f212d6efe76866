"""Selective rematerialization in the port (``ops/remat.py``: ``remat``
True, False, ``"attn"``, ``"dots"``) against the JAX package's
``remat_policy`` at ``MMMMConfig.tiny()`` in fp32 on the CPU.

- Each new policy (``"attn"``, ``"dots"``; True and False are held in
  tests/test_torch_port_train.py) in both grounding modes the parity tests
  take (``"none"``, ``"semantic"``) and on both attention routes
  (``"xla"``, ``"pallas"``): three port steps against the JAX step under the
  same policy, at tests/test_torch_port_train.py's tolerances (its
  ``check_steps``). The JAX side runs ``attn_impl="xla"``: the policy is what
  is held, and the route is held in that file.
- The four policies against each other: bit for bit on the CPU (a policy
  decides what the backward keeps and what it recomputes; every op runs
  the same kernel on the same inputs either way).
- What the backward recomputes, standing in for the reference's FLOP check
  (tests/test_remat_engages.py): the flash operator's body runs at no site
  under False, at every site (2 LLM, 2 ViT, 2 SAM encoder layers) under
  True and ``"dots"``, and at the ViT's and the SAM encoder's only under
  ``"attn"`` (the LLM layers keep K3's output for K7); the products with no
  batch dimension (``aten.mm``) are recomputed none under False and
  ``"dots"``, and all of the layers' under True and ``"attn"`` (counted
  with torch's early stop of the recompute off: by default it skips a
  layer's ops after the last tensor the backward needs).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from mmmm_tpu_torch import LoraConfig, MMMMConfig, OptimizerConfig, make_optimizer
from mmmm_tpu_torch.models import mmmm as pmmmm
from mmmm_tpu_torch.models.cogvlm import decoder as pdecoder
from mmmm_tpu_torch.models.cogvlm import vit as pvit
from mmmm_tpu_torch.models.segvol import encoder as pencoder
from mmmm_tpu_torch.ops import flash as pflash
from mmmm_tpu_torch.ops import remat as premat
from mmmm_tpu_torch.peft.lora import flatten
from mmmm_tpu_torch.train.step import effective_params, init_train_state, make_train_step
from test_torch_port_train import LORA, OPT, check_steps, jax_run, port_step, train_batch

POLICIES = [False, True, "attn", "dots"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny tensors: the suite runs six
    workers on the host's cores, where each worker's default thread pool
    made these steps about ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("remat", ["attn", "dots"])
@pytest.mark.parametrize("mode", ["none", "semantic"])
def test_policy_matches_jax(mode, remat, attn):
    states, frozen, ref_logs = jax_run(mode, False, "xla", remat)
    check_steps(states, frozen, ref_logs, port_step(mode, attn, remat), train_batch(mode))


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["none", "semantic"])
def test_policies_agree_bit_for_bit(mode, attn):
    cfg = MMMMConfig.tiny()
    batch = train_batch(mode)
    runs = {}
    for remat in POLICIES:
        opt = make_optimizer(OptimizerConfig(**OPT))
        state, frozen = init_train_state(cfg, opt, LoraConfig(**LORA), device="cpu")
        step = make_train_step(cfg, opt, LoraConfig(**LORA), vg_mode=mode, attn_impl=attn,
                               remat=remat, dropout_seed=None, vis_span="auto", device="cpu")
        logs = []
        for _ in range(3):
            state, log = step(state, frozen, batch)
            logs.append({k: v.item() for k, v in log.items()})
        runs[remat] = logs, flatten(state.trainable)
    ref_logs, ref_tree = runs[True]
    for remat in POLICIES:
        logs, tree = runs[remat]
        assert logs == ref_logs, remat
        assert all(torch.equal(tree[k].detach(), ref_tree[k].detach()) for k in ref_tree), remat


class _CountMM(TorchDispatchMode):
    """Counts the products with no batch dimension that run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def semantic_model():
    cfg = MMMMConfig.tiny()
    lcfg = LoraConfig(**LORA)
    state, frozen = init_train_state(cfg, make_optimizer(OptimizerConfig(**OPT)), lcfg,
                                     device="cpu")
    # nonzero LoRA b factors, so that the merges are real products
    for path, t in flatten(state.trainable).items():
        if path.endswith("/b"):
            with torch.no_grad():
                t.normal_(generator=torch.Generator().manual_seed(len(path)))
    return cfg, lcfg, state, frozen


def _counts(semantic_model, remat, monkeypatch):
    """(flash bodies, products) run in the forward and in the backward of
    one semantic step on the flash route, and the products the layers
    (the bodies ``remat_call`` runs) take in the forward."""
    cfg, lcfg, state, frozen = semantic_model
    bodies = {"n": 0}
    body = pflash.flash_segment_attention

    def counted(*a, **k):
        bodies["n"] += 1
        return body(*a, **k)

    monkeypatch.setattr(pflash, "flash_segment_attention", counted)
    layer_mm = _CountMM()
    call = premat.remat_call

    def in_layers(fn, policy, *args):
        def counted_fn(*a):
            with layer_mm:
                return fn(*a)
        return call(counted_fn, policy, *args)

    for mod in (pdecoder, pvit, pencoder):
        monkeypatch.setattr(mod, "remat_call", in_layers)
    batch = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in train_batch("semantic").items()}
    params = effective_params(state.trainable, frozen, lcfg, False)
    fwd, bwd = _CountMM(), _CountMM()
    with set_checkpoint_early_stop(False):
        with fwd:
            loss, _ = pmmmm.training_step(params, cfg, batch, vg_mode="semantic",
                                          attn_impl="pallas", remat=remat, vis_span="auto")
        n_fwd, layers_fwd = bodies["n"], layer_mm.n
        with bwd:
            torch.autograd.grad(loss, list(flatten(state.trainable).values()),
                                allow_unused=True)
    return (n_fwd, fwd.n), (bodies["n"] - n_fwd, bwd.n), layers_fwd


def test_backward_recomputes_what_the_policy_says(semantic_model, monkeypatch):
    cfg = semantic_model[0]
    llm, vit = cfg.vlm.num_hidden_layers, cfg.vlm.vision.num_hidden_layers
    sites = llm + vit + cfg.sam.encoder_num_layers
    got = {str(r): _counts(semantic_model, r, monkeypatch) for r in POLICIES}
    assert {r: g[0][0] for r, g in got.items()} == {str(r): sites for r in POLICIES}
    assert {r: g[1][0] for r, g in got.items()} == {
        "False": 0, "True": sites, "attn": sites - llm, "dots": sites}
    # the products the backward recomputes: its count less the count under False
    base = got["False"][1][1]
    recomputed = {r: g[1][1] - base for r, g in got.items()}
    layers = got["False"][2]
    assert layers > 0 and all(g[2] == layers for g in got.values())
    assert recomputed == {"False": 0, "True": layers, "attn": layers, "dots": 0}


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        premat.remat_call(lambda x: x, "full", torch.ones(1))
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_train_step(MMMMConfig.tiny(), make_optimizer(OptimizerConfig()), LoraConfig(),
                        remat="everything", device="cpu")
