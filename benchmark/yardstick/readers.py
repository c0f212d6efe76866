"""What the per-layer metric readers share: each reader in
``benchmark/metrics/`` is one call into here with its own names, and
returns None where its cell gives it nothing to read."""
from __future__ import annotations

from . import peaks as pk
from . import trace as tr


def traced_units(ctx) -> int:
    wl = ctx["workload"]
    return len(ctx["traced"]["records"]) * wl.b


def stage_ms_per_unit(ctx, stage: str) -> float | None:
    if ctx["traced"] is None:
        return None
    us = tr.stage_kernel_us(ctx["traced"], stage)
    return None if us is None else us / 1e3 / traced_units(ctx)


def launches_per_unit(ctx) -> float | None:
    if ctx["traced"] is None:
        return None
    return len(ctx["traced"]["device"]) / traced_units(ctx)


def idle_percent(ctx) -> float | None:
    t = ctx["traced"]
    if t is None:
        return None
    w0, w1 = t["window_us"]
    return 100.0 * (1.0 - t["busy_us"] / (w1 - w0))


def mfu_percent(ctx) -> float | None:
    """Model FLOPs of the window over its wall time against the bf16 dense
    peak."""
    flops = ctx["workload"].model_flops(ctx["records"])
    return 100.0 * flops / ctx["window_s"] / ctx["peaks"][pk.RATE["bf16"]]


def roofline_percent(ctx, ops: tuple[str, ...]) -> float | None:
    """The least time of the named ops' work in the traced sub-window over
    the device time of the kernels that do it; an op none of whose kernels
    ran is left out, and None where none ran."""
    t = ctx["traced"]
    if t is None:
        return None
    work = ctx["workload"].attention_work(t["records"])
    least, patterns = 0.0, []
    for op in ops:
        pats = ctx["ops"].get(op, [])
        if not pats or not work.get(op) or tr.matched_us(t, pats) <= 0:
            continue
        least += sum(pk.least_seconds(f, b, rate, ctx["peaks"]) for f, b, rate in work[op])
        patterns += pats
    if not patterns:
        return None
    return 100.0 * least / (tr.matched_us(t, patterns) / 1e6)
