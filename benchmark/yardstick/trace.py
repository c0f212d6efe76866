"""The device trace of a short sub-window, read into what the per-layer
metrics need.

Frozen from the port's smoke script (``profile_run``), with two repairs:
the device's busy time is the union of its operations' intervals over the
sub-window (a sum double-counts overlapping streams), and every share is
taken over the same traced sub-window's wall time. Only the device events
and the named spans are read: reading a profiler's per-op tree costs about
a minute a million events.
"""
from __future__ import annotations

import bisect
import re
import time

TRACED = "bench.traced"  # the harness's span around the traced sub-window
BATCH = "bench.batch"  # the harness's span around one request batch or step


def profile(fn, spans: tuple[str, ...]) -> dict:
    """Run ``fn()`` under the profiler inside a ``bench.traced`` span and
    return ``read(...)``'s summary and ``fn``'s result."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(TRACED):
            result = fn()
    t0 = time.perf_counter()
    summary = read(prof.profiler.kineto_results.events(), spans)
    summary["read_s"] = time.perf_counter() - t0
    summary["result"] = result
    return summary


def read(events, spans: tuple[str, ...]) -> dict:
    from torch.autograd import DeviceType

    wanted = set(spans) | {TRACED, BATCH}
    device, host, dev_spans = [], [], []
    for e in events:
        name, dt = e.name(), e.device_type()
        if dt == DeviceType.CUDA:
            row = (e.start_ns() / 1e3, e.duration_ns() / 1e3, name)
            (dev_spans if name in wanted else device).append(row)
        elif name in wanted:
            host.append((e.start_ns() / 1e3, e.duration_ns() / 1e3, name))
    window = [h for h in host if h[2] == TRACED]
    if not window:
        raise RuntimeError("the trace holds no traced sub-window span")
    w0, wdur, _ = window[0]
    w1 = w0 + wdur
    device = sorted(d for d in device if w0 <= d[0] < w1)
    return {"window_us": (w0, w1), "device": device, "host": sorted(host),
            "device_spans": sorted(dev_spans), "busy_us": union_us(device, w0, w1)}


def union_us(device: list, lo: float, hi: float) -> float:
    """Length of the union of the device intervals, clipped to [lo, hi)."""
    total, end = 0.0, lo
    for start, dur, _ in device:
        s, e = max(start, end), min(start + dur, hi)
        if e > s:
            total += e - s
        end = max(end, min(start + dur, hi))
    return total


def stage_kernel_us(summary: dict, stage: str) -> float | None:
    """Device time of the operations that start inside the device-side
    spans of ``stage`` (a stage that runs several times sums its spans);
    None where the trace has no such span."""
    spans = [s for s in summary["device_spans"] if s[2] == stage]
    if not spans:
        return None
    starts = [d[0] for d in summary["device"]]
    total = 0.0
    for s0, sdur, _ in spans:
        lo, hi = bisect.bisect_left(starts, s0), bisect.bisect_left(starts, s0 + sdur)
        total += sum(d[1] for d in summary["device"][lo:hi])
    return total


def matched_us(summary: dict, patterns: list[str]) -> float:
    rx = [re.compile(p) for p in patterns]
    return sum(d[1] for d in summary["device"] if any(r.search(d[2]) for r in rx))


def top_ops(summary: dict, n: int = 10) -> list:
    by: dict[str, float] = {}
    for _, dur, name in summary["device"]:
        by[name] = by.get(name, 0.0) + dur
    return [[name[:200], us / 1e6] for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(summary: dict, n: int = 10) -> list:
    """Idle time of the device within the sub-window, summed by the
    innermost named host span open when each gap began."""
    w0, w1 = summary["window_us"]
    gaps, end = [], w0
    for start, dur, _ in summary["device"]:
        if start > end:
            gaps.append((end, start - end))
        end = max(end, start + dur)
    if w1 > end:
        gaps.append((end, w1 - end))
    host = summary["host"]
    by: dict[str, float] = {}
    for g0, glen in gaps:
        label = "outside spans"
        best = None
        for h0, hdur, name in host:
            if h0 <= g0 < h0 + hdur and (best is None or hdur < best):
                best, label = hdur, name
        by[label] = by.get(label, 0.0) + glen
    return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
