"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell, its configuration, its traffic and its metrics are found by name:
``BENCHMARK.json`` names them, ``benchmark/configs/<config>.json`` holds the
model as it is run, ``benchmark/traffic/<traffic>.json`` the traffic's
parameters and the ``kind`` of driver in ``benchmark/kinds/`` that reads
them, and ``benchmark/metrics/<metric>.py`` the reader of each metric
(``metric_path``: a name with a suffix after a dot shares the reader of
the name without it).

Set-up (imports, the kernels from the port's build directory, weights from
the configuration's weight seed, inputs from ``--seed``, the warm-up at the
cell's shapes) is timed as ``setup_s``; then
the cell runs for ``--seconds`` (the last batch or step is finished, and
the window ends with it); with ``--trace 1`` a short sub-window follows
under the profiler. Once the window has closed the program's state is
freed and the plain reference checks what the window produced. Progress
goes to standard error; the last line of standard output is the result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mmmm_tpu")

# a library the port may import must not bring JAX in by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_manifest(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def resolve(manifest: dict, workload: str, root: Path = HERE) -> dict:
    """The cell's entry, configuration, traffic and metric names."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
    covers = lambda m: workload in m.get("workloads", [workload])
    return {"cell": cell, "cfg": cfg, "traffic": traffic,
            "end_to_end": [m for m in manifest["end_to_end"] if covers(m)],
            "per_layer": [m for m in manifest["per_layer"] if covers(m)]}


def metric_path(name: str, root: Path = HERE) -> Path:
    """A metric's reader: ``metrics/<name>.py``, else the reader of the name
    cut at its last dot (``mfu.vqa`` is read by ``metrics/mfu.py`` unless
    ``metrics/mfu.vqa.py`` is there), and so on down to the first part."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader in {root / 'metrics'} for the metric {name!r}")


def metric_reader(name: str, root: Path = HERE):
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def op_tables(root: Path = HERE) -> dict:
    """``{op: [kernel name patterns]}`` from every ``benchmark/ops/*.json``."""
    ops: dict[str, list] = {}
    for f in sorted((root / "ops").glob("*.json")):
        entry = json.loads(f.read_text())
        ops.setdefault(entry["op"], []).extend(entry["kernels"])
    return ops


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def execute(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            control: str | None = None, t0: float = T0) -> dict:
    """Set up, run the window (and the traced sub-window), check; returns
    the result line's object with the compared numbers under ``check``."""
    import torch

    from .yardstick import peaks as pk
    from .yardstick import trace as tr

    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    wl = kind.Workload(spec["cfg"], spec["traffic"], seed, device, control=control)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    wl.setup()
    sync()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    units, i = 0, 0
    while True:
        units += wl.step(i)
        i += 1
        now = time.perf_counter()
        log(f"  {wl.unit[:-1]} batch {i}: {now - start:.3f} s into the window")
        if now - start >= seconds:
            break
    window_s = time.perf_counter() - start
    records = list(wl.records)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    ctx = {"setup_s": setup_s, "window_s": window_s, "units": units, "records": records,
           "workload": wl, "peak_bytes": peak, "ops": op_tables(), "traced": None,
           "peaks": pk.card_peaks(name)[1]}
    log(f"window {window_s:.3f} s, {units} {wl.unit}, peak {peak / 2**30:.3f} GiB; "
        f"{wl.describe(records)}")
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": power_limit() if on_card else None}
    breakdown = None
    if trace:
        n = spec["traffic"]["traced_batches"]
        summary = tr.profile(lambda: wl.traced(n, i), wl.spans)
        summary["records"] = summary.pop("result")
        ctx["traced"] = summary
        w0, w1 = summary["window_us"]
        device_info.update(busy_s=summary["busy_us"] / 1e6, window_s=(w1 - w0) / 1e6)
        breakdown = {"device_ops": tr.top_ops(summary), "idle_gaps": tr.idle_gaps(summary)}
        for op, pats in ctx["ops"].items():
            log(f"  op {op}: {tr.matched_us(summary, pats) / 1e3:.3f} ms of kernels matching {pats}")
        for op_name, sec in tr.top_ops(summary, 15):
            log(f"  {sec * 1e3:10.3f} ms  {op_name}")
        log(f"traced {n} batches: window {(w1 - w0) / 1e6:.3f} s, busy "
            f"{summary['busy_us'] / 1e6:.3f} s, {len(summary['device'])} device ops, read in "
            f"{summary['read_s']:.3f} s")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}: no JAX and nothing of the JAX package")
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    wl.free_program()
    t_check = time.perf_counter()
    check = wl.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")
    failed = wl.failed(records)
    correct = failed == 0 and all(c["ok"] for c in check.values())
    out = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics,
           "device": device_info, "served": wl.describe(records)}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in check.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = resolve(load_manifest(), args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = execute(spec, args.seed, args.seconds, bool(args.trace))
    for k, c in out["check"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
