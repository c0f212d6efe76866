"""Grounded radiology reports in a closed loop through the port's
``generate_grounded``: one client sends a batch of studies, waits for its
reports and masks, and sends the next.

The traffic file fixes the batch, the volumes' shapes, the prompt layout
(a bos, the image's tokens, then text), the range of text lengths, the new
tokens, the decoding (greedy, or n-gram speculation with a draft length)
and the grounding; its optional ``generate`` passes further options of
``generate_grounded`` through. A key this driver does not know is refused
before any set-up, as is a configuration whose precision the reference
does not model. Every seed serves the same set of text lengths, spread
evenly over the range and dealt to the pool's batches in another order;
ids and volumes come from the seed, the weights from the configuration's
``weight_seed``, so every seed serves the same model. Where the traffic
states a ``content_seed``, the pool's lengths, ids and volumes come from it
instead and the seed deals the same batches, each with the same studies,
in another order: where what a prompt holds sets the work (how many drafts
n-gram speculation accepts), every seed then does the same work. The
window cycles through the pool. Prompts are right-padded to the longest the traffic
allows, so every batch has the same shapes and one warm-up batch builds
them all.

The check runs the fp32 reference once the window has closed over the
requests of a few batches: the window's first, which serves the longest
prompt, and others drawn from the seed: the widest gap by which a served
token's logit lies below the reference's best at its position, read apart
where the served token or the reference's best is a token whose head
column the configuration biases (``tag_gap``; such a logit carries the bias
times the sum of the hidden state, so its rounding is that sum's) and
elsewhere (``logit_gap``); and the largest error of a mask against the
reference's mask for the same ``</p>`` state, relative to that mask's
largest logit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import weights as W
from ..flops import vividmed as fl
from ..reference import vividmed as ref_model

SPANS = ("vit", "llm_prefill", "decode", "sam")
TRAFFIC_KEYS = {"kind", "about", "batch", "pool_batches", "image", "image_dtype", "patch_size",
                "pool_size", "vision_tokens", "text_tokens", "grounding_image", "new_tokens",
                "spec_draft_len", "max_targets", "force_grounding", "warmup_batches",
                "traced_batches", "check", "generate", "content_seed"}
# options of ``generate_grounded`` a traffic file may set under ``generate``:
# each changes how the reports are computed, not what a report holds
GENERATE_OPTIONS = {"prefill_chunk", "chunk_mode", "w8a8", "w8a8_prefill", "q8_mxu",
                    "gelu_mode", "dense_fast_softmax", "q8_cast"}
CHECK_LIMITS = {"logit_gap", "tag_gap", "mask_err"}


def refuse_unknown(cfg: dict, traffic: dict) -> None:
    """Raise on what this driver or the reference would otherwise leave
    out without a word."""
    unknown = set(traffic) - TRAFFIC_KEYS
    unknown |= {f"generate.{k}" for k in set(traffic.get("generate", {})) - GENERATE_OPTIONS}
    unknown |= {f"check.limits.{k}" for k in set(traffic["check"]["limits"]) - CHECK_LIMITS}
    if unknown:
        raise ValueError(f"the grounded_reports driver does not know {sorted(unknown)}: "
                         "a traffic that needs them needs a kind of its own")
    if cfg.get("grounding_dtype", "float32") != "float32":
        raise ValueError("the grounded_reports driver runs the SAM head in float32 only")
    if cfg["kv_cache_dtype"] not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {cfg['kv_cache_dtype']!r}")
    ref_model.refuse_unmodelled(cfg)


@dataclasses.dataclass
class Batch:
    ids: torch.Tensor
    tt: torch.Tensor
    pos: torch.Tensor
    lens: torch.Tensor
    image: torch.Tensor
    g_image: torch.Tensor
    lens_host: list


class Workload:
    unit = "reports"
    spans = SPANS

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *, control: str | None = None):
        refuse_unknown(cfg, traffic)
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.weight_seed = cfg["weight_seed"]
        self.dev = torch.device(device)
        self.bits = {None: cfg["llm_weight_bits"], "w4": 4}[control]
        self.b = traffic["batch"]
        self.records: list[dict] = []
        self.program = None

    # ---- set-up --------------------------------------------------------
    def setup(self) -> None:
        from mmmm_tpu_torch import MMMMConfig, quantize_llm_for_serving
        from mmmm_tpu_torch.data.tokenizer import SPECIAL_TOKENS, MMMMTokenizer, _ByteBackend
        from mmmm_tpu_torch.models.cogvlm.config import CogVLMConfig, VisionConfig
        from mmmm_tpu_torch.models.inference import generate_grounded
        from mmmm_tpu_torch.models.segvol import SamConfig

        if self.dev.type == "cuda":
            from mmmm_tpu_torch.ops._cuda import library

            library()  # the kernels, built once per checkout
        vlm = {k: (tuple(v) if isinstance(v, list) else v)
               for k, v in self.cfg["vlm"].items() if k != "vision"}
        vis = {k: (tuple(v) if isinstance(v, list) else v)
               for k, v in self.cfg["vlm"]["vision"].items()}
        sam = {k: (tuple(v) if isinstance(v, list) else v) for k, v in self.cfg["sam"].items()}
        self.mcfg = MMMMConfig(vlm=CogVLMConfig(**vlm, vision=VisionConfig(**vis)),
                               sam=SamConfig(**sam))
        base = self.cfg["special_tokens_base"]
        self.tok = MMMMTokenizer(_ByteBackend(), {t: base + i for i, t in enumerate(SPECIAL_TOKENS)})
        self.generate = generate_grounded
        params = W.make_tree(self.cfg, self.weight_seed, self.dev)
        if self.bits in (4, 8):
            params["cogvlm"] = quantize_llm_for_serving(params["cogvlm"], bits=self.bits)
        self.program = params
        self._sync()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        self.pool = self._make_pool()
        self.keep = self._keep_indices()
        for i in range(self.tr["warmup_batches"]):
            self._run(self.pool[i % len(self.pool)])

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _make_pool(self) -> list:
        tr, b = self.tr, self.b
        n_vis, (lo, hi) = tr["vision_tokens"], tr["text_tokens"]
        p = tr["pool_batches"]
        src = tr.get("content_seed", self.seed)
        lengths = np.rint(np.linspace(lo, hi, p * b)).astype(int)
        lengths = np.random.default_rng([src, 1]).permutation(lengths)
        smax = 1 + n_vis + hi
        vocab = self.cfg["special_tokens_base"]
        pool = []
        for k in range(p):
            rng = np.random.default_rng([src, 2, k])
            ids = np.zeros((b, smax), np.int32)
            tt = np.zeros((b, smax), np.int32)
            pos = np.zeros((b, smax), np.int32)
            lens = []
            for r in range(b):
                text = int(lengths[k * b + r])
                n = 1 + n_vis + text
                ids[r, :n] = np.concatenate([[1], np.full(n_vis, 3), rng.integers(4, vocab, text)])
                tt[r, 1:1 + n_vis] = 1
                pos[r, :n] = np.concatenate([[0, 1], np.full(n_vis - 2, 2), [3],
                                             np.arange(4, 4 + text)])
                lens.append(n)
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(W.leaf_seed(src, "image", k))
            image = torch.randn((b, *tr["image"]), generator=gen, device=self.dev,
                                dtype=W.DTYPES[tr["image_dtype"]])
            gen.manual_seed(W.leaf_seed(src, "grounding_image", k))
            g_image = torch.randn((b, *tr["grounding_image"]), generator=gen, device=self.dev)
            to = lambda a: torch.as_tensor(a, device=self.dev)
            pool.append(Batch(to(ids), to(tt), to(pos), to(np.array(lens, np.int32)), image,
                              g_image, lens))
        if "content_seed" in tr:
            pool = self._deal(pool)
        # the window opens on the batch that serves the longest prompt
        longest = max(range(p), key=lambda k: max(pool[k].lens_host))
        first = self.tr["warmup_batches"] % p
        pool[first], pool[longest] = pool[longest], pool[first]
        return pool

    def _deal(self, pool: list) -> list:
        """The same batches in an order drawn from the seed, each with its
        studies in an order drawn from the seed."""
        rng = np.random.default_rng([self.seed, 4])
        out = []
        for k in rng.permutation(len(pool)):
            x, rows = pool[k], rng.permutation(self.b)
            at = torch.as_tensor(rows, device=self.dev)
            out.append(Batch(x.ids[at], x.tt[at], x.pos[at], x.lens[at], x.image[at],
                             x.g_image[at], [x.lens_host[r] for r in rows]))
        return out

    def _keep_indices(self) -> set:
        """Window batches whose masks are kept for the check: the first,
        which serves the longest prompt, and others drawn from the seed."""
        rng = np.random.default_rng([self.seed, 3])
        others = rng.choice(np.arange(1, 2 * len(self.pool)),
                            size=self.tr["check"]["kept_batches"] - 1, replace=False)
        return {0, *(int(i) for i in others)}

    # ---- the window ----------------------------------------------------
    def _run(self, batch: Batch):
        tr = self.tr
        res = self.generate(
            self.program, self.mcfg, self.tok, batch.ids, batch.tt, batch.pos, batch.lens,
            batch.image, tuple(tr["patch_size"]), tuple(tr["pool_size"]),
            max_new_tokens=tr["new_tokens"], max_targets=tr["max_targets"],
            grounding_image=batch.g_image, force_grounding=tr["force_grounding"],
            vis_span=(1, 1 + tr["vision_tokens"]), kv_cache_dtype=self.cfg["kv_cache_dtype"],
            spec_draft_len=tr["spec_draft_len"], device=self.dev, **tr.get("generate", {}))
        self._sync()
        return res

    def step(self, i: int) -> int:
        """Batch ``i`` of the window (after the warm-up); returns the reports
        it completed."""
        from torch.profiler import record_function

        k = (i + self.tr["warmup_batches"]) % len(self.pool)
        with record_function("bench.batch"):
            res = self._run(self.pool[k])
        rec = {"pool": k, "tokens": res.tokens, "num_generated": res.num_generated,
               "spec": res.spec_stats}
        masks = res.masks
        want = (self.b, self.tr["max_targets"], *self.tr["grounding_image"][1:])
        rec["answered"] = int((res.num_generated > 0).sum()) if (
            masks is not None and tuple(masks.shape) == want
            and res.tokens.shape == (self.b, self.tr["new_tokens"])) else 0
        if i in self.keep:
            rec["masks"] = masks
        self.records.append(rec)
        return self.b

    def traced(self, n: int, start: int) -> list:
        out = []
        for i in range(start, start + n):
            self.step(i)
            out.append(self.records.pop())
        return out

    def free_program(self) -> None:
        self.program = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- counts --------------------------------------------------------
    def failed(self, records) -> int:
        return sum(self.b - r["answered"] for r in records)

    def steps(self, rec) -> list:
        """Per row, (write index, window tokens) of every decode step it was
        active in."""
        batch = self.pool[rec["pool"]]
        out = []
        for r in range(self.b):
            n = int(rec["num_generated"][r])
            served = [int(t) for t in rec["tokens"][r][:n]]
            length = batch.lens_host[r]
            if self.tr["spec_draft_len"] > 0:
                prompt = batch.ids[r, :length].tolist()
                out.append(fl.replay_verify_steps(prompt, served, self.tr["new_tokens"],
                                                  self.tr["spec_draft_len"]))
            else:
                out.append(fl.greedy_steps(length, self.tr["new_tokens"]))
        return out

    def model_flops(self, records) -> float:
        """The model's FLOPs for what was served: each served token after the
        first (which the prefill's last position gives) once, as a greedy
        decode would compute it; a verify window's rejected drafts are the
        decoder's work, not the model's."""
        tr, total = self.tr, 0.0
        for rec in records:
            lens = self.pool[rec["pool"]].lens_host
            total += self.b * fl.vit_flops(self.cfg, tr["image"], tr["patch_size"], tr["pool_size"])
            total += fl.prefill_flops(self.cfg, lens)
            total += fl.decode_flops(self.cfg, [
                fl.greedy_steps(lens[r], max(int(rec["num_generated"][r]) - 1, 0))
                for r in range(self.b)])
            total += self.b * fl.sam_flops(self.cfg, tr["grounding_image"], tr["patch_size"],
                                           tr["max_targets"])
        return total

    def attention_work(self, records) -> dict:
        tr, work = self.tr, {}
        for rec in records:
            kw = dict(images=self.b, image=tr["image"], g_image=tr["grounding_image"],
                      patch=tr["patch_size"], prompt_lens=self.pool[rec["pool"]].lens_host,
                      steps=self.steps(rec))
            for op in ("vit_attn", "sam_encoder_attn", "prefill_attn", "decode_window_attn",
                       "decode_attn"):
                work.setdefault(op, []).extend(getattr(fl, op)(self.cfg, **kw))
        return work

    def spec_tokens_per_step(self, records) -> float | None:
        specs = [r["spec"] for r in records if r["spec"]]
        if not specs:
            return None
        steps = sum(s["iters"] for s in specs) * self.b
        return sum(s["tokens_per_step"] * s["iters"] * self.b for s in specs) / steps

    def describe(self, records) -> str:
        tps = self.spec_tokens_per_step(records)
        gen = sum(int(r["num_generated"].sum()) for r in records)
        eop = self.cfg["special_tokens_base"] + 5
        ends = sum(int((r["tokens"] == eop).sum()) for r in records)
        return (f"{gen} tokens served, {ends / max(len(records) * self.b, 1):.3f} </p> a report"
                + ("" if tps is None else f", {tps:.4f} tokens a verify step"))

    # ---- the check -----------------------------------------------------
    def check(self) -> dict:
        """The compared numbers of the kept batches, each beside its limit."""
        ref_model.strict_fp32()
        kept = [r for r in self.records if "masks" in r]
        limits = self.tr["check"]["limits"]
        if not kept:
            return {"requests_checked": {"value": 0, "limit": 1, "ok": False}}
        ref = ref_model.Reference(self.cfg, self.weight_seed, self.dev)
        rows = [(rec, r) for rec in kept for r in range(self.b)]
        worst = dict.fromkeys(("logit_gap", "tag_gap", "mask_err"), 0.0)
        chunk = self.tr["check"]["rows_per_pass"]
        with torch.no_grad():
            head = ref.lm_head()
            for i in range(0, len(rows), chunk):
                for k, v in self._check_rows(ref, head, rows[i:i + chunk]).items():
                    worst[k] = max(worst[k], v)
        if not self.cfg["head_bias"]:
            del worst["tag_gap"]
        out = {k: {"value": v, "limit": limits[k], "ok": v <= limits[k]} for k, v in worst.items()}
        out["requests_checked"] = {"value": len(rows), "limit": 1, "ok": len(rows) >= 1}
        return out

    def _check_rows(self, ref, head, rows) -> dict:
        tr, cfg = self.tr, self.cfg
        base = cfg["special_tokens_base"]
        bop, eop = base + 4, base + 5
        n_vis = tr["vision_tokens"]
        seqs = []
        for rec, r in rows:
            batch = self.pool[rec["pool"]]
            length = batch.lens_host[r]
            n = int(rec["num_generated"][r])
            served = [int(t) for t in rec["tokens"][r][:n]]
            ids = batch.ids[r, :length].tolist()
            pos = batch.pos[r, :length].tolist()
            pos += ref_model.continue_positions(pos[-1], ids[-1], served, bop, eop)
            tt = batch.tt[r, :length].tolist() + [0] * n
            seqs.append((ids + served, tt, pos, length, served))
        s = max(len(q[0]) for q in seqs)
        pad = lambda a: a + [0] * (s - len(a))
        to = lambda xs, dt=torch.long: torch.tensor([pad(x) for x in xs], dtype=dt, device=self.dev)
        ids, tt, pos = to([q[0] for q in seqs]), to([q[1] for q in seqs]), to([q[2] for q in seqs])
        valid = torch.tensor([[j < len(q[0]) for j in range(s)] for q in seqs], device=self.dev)
        images = torch.stack([self.pool[rec["pool"]].image[r] for rec, r in rows])
        vis = ref.vision_tokens(images, tr["patch_size"], tr["pool_size"])
        del images
        x = ref.embed(ids)
        x[:, 1:1 + n_vis] = vis
        hidden = ref.llm_hidden(x, tt, pos, valid)
        gaps = {"logit_gap": 0.0, "tag_gap": 0.0}
        tags = torch.tensor(sorted(int(t) for t in cfg["head_bias"]), dtype=torch.long,
                            device=self.dev)
        prompts = []
        for j, (ids_, _, _, length, served) in enumerate(seqs):
            h = hidden[j, length - 1:length - 1 + len(served)]
            if served:
                logits = h @ head
                tok = torch.tensor(served, device=self.dev)
                best = logits.max(dim=1)
                gap = best.values - logits.gather(1, tok[:, None])[:, 0]
                tag = torch.isin(tok, tags) | torch.isin(best.indices, tags)
                for k, sel in (("logit_gap", ~tag), ("tag_gap", tag)):
                    if sel.any():
                        gaps[k] = max(gaps[k], float(gap[sel].max()))
            rec, r = rows[j]
            eops = np.nonzero(rec["tokens"][r] == eop)[0][:tr["max_targets"]]
            at = np.zeros(tr["max_targets"], np.int64)
            at[:len(eops)] = eops
            prompts.append(hidden[j, length - 1 + torch.as_tensor(at, device=self.dev)])
        vg = ref.vg_project(torch.stack(prompts))
        g_image = torch.stack([self.pool[rec["pool"]].g_image[r] for rec, r in rows])
        want = ref.sam_masks(g_image, tr["patch_size"], vg)
        got = torch.stack([rec["masks"][r] for rec, r in rows]).float()
        scale = want.flatten(2).abs().amax(dim=2).clamp_min(1e-12)
        gaps["mask_err"] = float(((got - want).flatten(2).abs().amax(dim=2) / scale).max())
        return gaps
