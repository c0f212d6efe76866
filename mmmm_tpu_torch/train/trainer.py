"""The training loop, the port of ``mmmm_tpu/train/trainer.py``: stream ->
buckets -> the step of each batch's grounding mode -> logs and checkpoints.

Samples stream from ``MultiDataset`` through the host-invariant schedule
(``data/batching.py scheduled_batches``); ``BucketBatcher`` groups them
into static-shape numpy batches; each batch goes to the step of its
``vg_mode`` (``train/step.py make_train_step``), which moves it to the
device. Logs are written to ``<out_dir>/metrics.jsonl`` (``step``, every
log of the step and ``steps_per_sec``) every ``log_every`` steps; between
them and the checkpoints the loop never waits for the device. Checkpoints
go to ``<out_dir>/ckpt`` (``CheckpointManager``), and the trainable tree is
exported to ``<out_dir>/adapter.npz`` at the end, which the JAX package's
``load_adapter`` reads.

Data parallel over processes (the reference's trainer.py:89-108): the
trainer calls ``init_distributed`` (a no-op for one process) and builds a
``data`` mesh when ``mesh_data`` is set or there is more than one process
(``mesh_data`` None: ``gcd(batch_size, processes)``, which must then be
every process). Each process reads its slice of every batch of the one
schedule (``scheduled_batches(rank=, world_size=)``), the steps run on that
mesh with ZeRO-3 (``train/step.py place_state``), and only rank 0
writes ``metrics.jsonl`` and ``adapter.npz`` and reads and writes the
checkpoints (whole tensors, gathered; ``out_dir`` need not be shared). Under ``MMMM_DEBUG`` every batch is checked for even
slices and, every ``log_every`` steps, the step and the replicated
trainable leaves for equality across processes (``parallel/debug.py``).
``mesh_model``, ``mesh_seq`` or ``mesh_pipe`` above 1 raise: tensor,
sequence and pipeline parallelism wait for ROADMAP Queue 1 items 8b and 8c.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ..data.batching import BucketBatcher, scheduled_batches
from ..data.dataset import MultiDataset
from ..models.mmmm import MMMMModel
from ..ops._cuda import resolve_device
from ..parallel.debug import assert_replicated_equal, check_batch_uniform
from ..parallel.distributed import init_distributed, mesh_device, process_rank
from ..parallel.mesh import make_mesh
from ..parallel.zero import gather_tree
from ..peft.lora import LoraConfig, flatten
from .checkpoint import CheckpointManager, save_adapter
from .optim import OptimizerConfig, make_optimizer
from .step import TrainState, init_train_state, make_train_step, place_state


@dataclasses.dataclass(kw_only=True)
class TrainerConfig:
    max_steps: int = 1000
    log_every: int = 50
    ckpt_every: int = 2000
    out_dir: str = "runs/default"
    seed: int = 42
    batch_size: int = 8
    mesh_model: int = 1  # tensor-parallel degree
    mesh_seq: int = 1  # sequence-parallel (ring attention) degree
    mesh_pipe: int = 1  # pipeline-parallel degree
    pipe_micro: int = 4  # microbatches per pipeline step
    mesh_data: int | None = None  # data-parallel degree; None = auto
    bf16_vlm: bool = True
    # store the frozen CogVLM base in bf16 (the compute dtype under bf16_vlm)
    frozen_vlm_bf16: bool = True
    # True, False, "attn" or "dots" (ops/remat.py; YAML and overrides pass
    # the string as it is, as the reference's)
    remat: bool | str = True
    # the reference's MMMM_GELU: "auto", "fitted", "tanh" or "erf"
    gelu_mode: str = "auto"
    # "pallas" runs K3 and K7 at every flash site; "xla" is the plain
    # PyTorch attention and launches no kernel. Decided on the H100: at the
    # training LLM site K3 takes 0.1538 ms against 4.5285 plain, the whole
    # K7 backward 0.4278 against 9.5540 (PERF.md, the kernel table)
    attn_impl: str = "pallas"
    # static single-expert routing over the image span; "auto" is exact for
    # batches built by data/input_builder.py (vision tokens at [1, 1+n_img))
    vis_span: tuple[int, int] | str | None = "auto"
    keep_ckpts: int | None = None
    # torch.profiler window [start, start + steps) in steps; a chrome trace
    # lands in <out_dir>/profile
    profile_start: int | None = None
    profile_steps: int = 3


class Trainer:
    def __init__(self, model: MMMMModel, dataset: MultiDataset, opt_cfg: OptimizerConfig,
                 lora_cfg: LoraConfig, cfg: TrainerConfig,
                 device: str | torch.device = "cuda"):
        for key, item in (("mesh_model", "8b"), ("mesh_seq", "8c"), ("mesh_pipe", "8c")):
            if getattr(cfg, key) > 1:
                raise NotImplementedError(
                    f"Trainer: {key}={getattr(cfg, key)}; the port trains data parallel only, "
                    f"this parallelism waits for ROADMAP Queue 1 item {item}")
        self.model = model
        self.dataset = dataset
        self.opt_cfg = opt_cfg
        self.lora_cfg = lora_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(opt_cfg)
        self.out_dir = Path(cfg.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        init_distributed(device=self.device)
        self.mesh, self.group, self.host_group = None, None, None
        self.rank, self.world = 0, 1
        _, world = process_rank()
        if cfg.mesh_data is not None or world > 1:
            data = cfg.mesh_data or math.gcd(cfg.batch_size, world)
            self.mesh = make_mesh(data=data, device=self.device)
            self.device = mesh_device(self.mesh)
            self.group = self.mesh.get_group("data")
            self.rank, self.world = self.mesh.get_local_rank("data"), data
            # host-side flags travel over gloo, so that reading one never waits
            # for the card's queue
            self.host_group = self.group if dist.get_backend(self.group) == "gloo" else \
                dist.new_group(dist.get_process_group_ranks(self.group), backend="gloo")
        self.steps = {
            mode: make_train_step(model.cfg, self.optimizer, lora_cfg, vg_mode=mode,
                                  bf16_vlm=cfg.bf16_vlm, attn_impl=cfg.attn_impl,
                                  remat=cfg.remat, vis_span=cfg.vis_span,
                                  gelu_mode=cfg.gelu_mode, device=self.device, mesh=self.mesh)
            for mode in ("none", "semantic", "instance")
        }
        # host seconds of the last fit: each step's wait for its batch
        # (plans, loads, transforms, collation), each checkpoint save, and
        # the adapter export
        self.seconds: dict = {"data": [], "checkpoint": [], "export": 0.0}

    def _log(self, step: int, logs: dict):
        if self.rank != 0:  # every process holds the global batch's logs
            return
        rec = {"step": step, **{k: float(v) for k, v in logs.items()}}
        with (self.out_dir / "metrics.jsonl").open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    def fit(self, resume: bool = True,
            state: tuple[TrainState, dict] | None = None) -> TrainState:
        """Train to ``max_steps``; returns the final state. ``state`` is a
        ``(TrainState, frozen)`` pair to start from (it is updated in
        place); by default ``init_train_state`` from ``cfg.seed``. With
        ``resume`` the latest checkpoint under ``out_dir`` replaces its
        trainable tree, optimizer state and step."""
        cfg = self.cfg
        if state is None:
            state, frozen = init_train_state(
                self.model.cfg, self.optimizer, self.lora_cfg, seed=cfg.seed,
                frozen_vlm_bf16=cfg.frozen_vlm_bf16 and cfg.bf16_vlm, device=self.device)
        else:
            state, frozen = state

        def tree(s: TrainState) -> dict:
            return {"trainable": s.trainable, "opt_state": s.opt_state}

        def whole_tree(s: TrainState):
            return lambda: gather_tree(tree(s))

        ckpt = CheckpointManager(self.out_dir / "ckpt", cfg.ckpt_every, cfg.keep_ckpts,
                                 group=self.group)
        start_step = 0
        if resume:
            step, restored = ckpt.restore(tree(state))
            if step is not None:
                for t in flatten(restored["trainable"]).values():
                    t.requires_grad_(True)
                state = TrainState(step, restored["trainable"], restored["opt_state"])
                start_step = step
                print(f"resumed from step {step}", flush=True)
        if self.mesh is not None:  # this process keeps its ZeRO-3 chunks
            state, frozen = place_state(state, frozen, self.mesh)

        some_transform = next(iter(self.dataset.transforms.values()))
        batcher = BucketBatcher(
            cfg.batch_size, eop_token_id=some_transform.tokenizer.eop_token_id,
            max_targets=self.dataset.conf.max_targets,
            max_instances=self.dataset.conf.max_instances,
            max_seq_len=self.dataset.conf.max_seq_len)
        # stream enough samples for the remaining steps (some batches flush
        # partial); every process plans the same schedule and collates its
        # slice of each batch
        remaining = cfg.max_steps - start_step
        batch_stream = scheduled_batches(self.dataset, batcher, remaining * cfg.batch_size * 2,
                                         seed=cfg.seed + start_step, rank=self.rank,
                                         world_size=self.world)
        debug = self.mesh is not None and bool(os.environ.get("MMMM_DEBUG"))

        # SIGTERM / SIGINT ask for a checkpoint at the next step boundary
        preempted = {"flag": False}

        def on_signal(signum, frame):
            preempted["flag"] = True
            print(f"signal {signum}: checkpointing at next step boundary", flush=True)

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass

        step_i = start_step
        self.seconds = {"data": [], "checkpoint": [], "export": 0.0}
        prof = None
        t0 = time.time()
        try:
            while step_i < cfg.max_steps:
                t_data = time.perf_counter()
                batch = next(batch_stream, None)
                if batch is None:
                    break
                self.seconds["data"].append(time.perf_counter() - t_data)
                if self._any_process(preempted["flag"]):
                    ckpt.force_save(step_i, whole_tree(state))
                    print(f"preemption checkpoint saved at step {step_i}", flush=True)
                    break
                if cfg.profile_start is not None and step_i == cfg.profile_start:
                    activities = [ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        activities.append(ProfilerActivity.CUDA)
                    prof = profile(activities=activities)
                    prof.start()
                mode = batch.pop("vg_mode")
                batch.pop("src", None)
                if debug:
                    check_batch_uniform({k: v for k, v in batch.items()
                                         if k not in ("patch_size", "pool_size")},
                                        self.mesh, world_size=self.world)
                state, logs = self.steps[mode](state, frozen, batch)
                step_i += 1
                if debug and step_i % cfg.log_every == 0:
                    assert_replicated_equal(
                        {"step": torch.tensor(state.step, device=self.device),
                         "trainable": state.trainable}, self.mesh)
                if prof is not None and step_i >= cfg.profile_start + cfg.profile_steps:
                    self._stop_profile(prof)
                    prof = None
                if step_i % cfg.log_every == 0 or step_i == cfg.max_steps:
                    dt = time.time() - t0
                    self._log(step_i, {**logs, "steps_per_sec": cfg.log_every / max(dt, 1e-9)})
                    t0 = time.time()
                t_save = time.perf_counter()
                if ckpt.maybe_save(step_i, whole_tree(state)):
                    self.seconds["checkpoint"].append(time.perf_counter() - t_save)
        finally:
            if prof is not None:
                self._stop_profile(prof)
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        ckpt.wait()
        t_export = time.perf_counter()
        trainable = gather_tree(state.trainable)
        if self.rank == 0:
            save_adapter(self.out_dir / "adapter.npz", trainable)
        self.seconds["export"] = time.perf_counter() - t_export
        return state

    def _any_process(self, flag: bool) -> bool:
        """``flag`` on any process (a signal reaches one process; every
        process must checkpoint at the same step)."""
        if self.host_group is None:
            return flag
        t = torch.tensor(int(flag))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t)

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.out_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
