"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's), and
the reference loads nothing of the port."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    mods = _top_level_after("import benchmark.run, benchmark.readings, "
                            "benchmark.kinds.grounded_reports, benchmark.yardstick.readers, "
                            "benchmark.reference.vividmed")
    assert not mods & {"jax", "jaxlib", "flax", "mmmm_tpu"}


def test_reference_loads_nothing_of_the_port():
    mods = _top_level_after("import benchmark.reference.vividmed, benchmark.weights")
    assert "mmmm_tpu_torch" not in mods and not mods & {"jax", "jaxlib", "flax", "mmmm_tpu"}


def test_a_whole_run_loads_no_jax(small_spec, tmp_path):
    """A run on the CPU through the port, in a fresh interpreter."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(small_spec))
    code = ("import json, time\nfrom benchmark import run\n"
            f"spec = json.load(open({str(spec)!r}))\n"
            "out = run.execute(spec, 6000000001, 0.2, False, device='cpu', t0=time.perf_counter())\n"
            "assert out['correct'], out\n"
            "assert run.forbidden_modules() == []")
    mods = _top_level_after(code)
    assert "mmmm_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mmmm_tpu"}
