"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
resolved to its file."""
from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])


def test_top_level_keys_and_run_length():
    assert set(MANIFEST) == KEYS
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_command_and_paths_stay_inside_the_benchmark():
    assert MANIFEST["paths"] == ["benchmark"]
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word and 1 <= len(word) <= 200
    assert MANIFEST["command"][-1] == "benchmark.run"


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metrics_units_sources_and_bounds():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_moves_is_an_end_to_end_metric_of_the_same_cells():
    e2e = {m["name"]: set(_cells(m)) for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(_cells(m)) <= e2e[m["moves"]], m["name"]
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_cell_resolves_by_name_on_one_chip():
    from benchmark import run

    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        spec = run.resolve(MANIFEST, w["name"])
        assert (BENCH / "kinds" / f"{spec['traffic']['kind']}.py").exists()
        assert any(m["name"] != "setup_s" for m in spec["end_to_end"])
        assert spec["per_layer"], w["name"]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert used == set(configs)


def test_configs_name_their_file_and_every_reduced_key():
    for c in MANIFEST["configs"]:
        f = ROOT / c["file"]
        assert f.is_relative_to(BENCH) and f.exists()
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank", "_size"))


def test_every_metric_has_a_reader_and_every_op_file_is_well_formed():
    from benchmark import run

    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(run.metric_reader(m["name"])), m["name"]
    ops = run.op_tables()
    from benchmark.flops import vividmed as fl

    for op, patterns in ops.items():
        assert callable(getattr(fl, op)) and patterns
        for p in patterns:
            re.compile(p)


def test_a_later_cell_is_found_by_its_files_alone(tmp_path):
    """A new cell of an existing kind needs a traffic file and entries in
    ``BENCHMARK.json`` only; a new metric needs its reader file."""
    from benchmark import run

    root = tmp_path / "benchmark"
    (root / "traffic").mkdir(parents=True)
    (root / "metrics").mkdir()
    traffic = json.loads((BENCH / "traffic" / "report_spec7_b4.json").read_text())
    traffic["batch"] = 8
    (root / "traffic" / "report_spec7_b8.json").write_text(json.dumps(traffic))
    (root / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 1.5\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "serve_report_spec7_b8", "config": "vividmed17b-w8a16",
                                  "traffic": "report_spec7_b8", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                                  "source": "device_trace", "layer": "decode",
                                  "moves": "reports_per_s"})
    spec = run.resolve(manifest, "serve_report_spec7_b8", root=root)
    assert spec["traffic"]["batch"] == 8
    assert "new_metric" in [m["name"] for m in spec["per_layer"]]
    assert run.metric_reader("new_metric", root=root)({}) == 1.5
    # a suffix after a dot shares the reader of the name without it
    assert run.metric_reader("new_metric.cell_b", root=root)({}) == 1.5
    assert run.metric_path("mfu.train") == BENCH / "metrics" / "mfu.py"
    (root / "metrics" / "new_metric.cell_c.py").write_text("def read(ctx):\n    return 2.5\n")
    assert run.metric_reader("new_metric.cell_c", root=root)({}) == 2.5
    with pytest.raises(FileNotFoundError):
        run.metric_path("no_such_metric.serve")
    assert math.isclose(run.metric_reader("setup_s")({"setup_s": 2.0}), 2.0)
