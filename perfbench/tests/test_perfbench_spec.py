"""BENCHMARK.json keeps to the benchmark's contract, every cell resolves
its parts by name, and nothing the benchmark runs imports JAX."""

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import run, weights

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_hold_only_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        names += [c["name"]] + c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        reported = {m["name"] for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", CELLS)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", CELLS)]
        assert layer and any("mfu" in m["name"] for m in layer)
        assert all(m["moves"] in reported for m in layer)



@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_its_parts_by_name(cell):
    parts = run.cell_parts(BENCH, cell)
    assert callable(parts["driver"].run)
    assert hasattr(parts["generator"], "Generator")
    for m in parts["end_to_end"] + parts["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)
    limits = parts["limits"]
    assert set(limits) == {"missing", "ids_bad_rows", "bucket_bad",
                           "frames_bad_rows", "dur_gap", "mel_gap",
                           "wave_gap"}
    cfg = parts["config"]
    spec = run.find(BENCH["configs"], parts["cell"]["config"], "config")
    assert spec["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert spec["reduced"] == cfg["reduced"] == []


def test_configurations_match_their_artifact():
    for c in BENCH["configs"]:
        cfg = weights.load_config(c["name"])
        assert cfg["precision"] == {"compute": "float32", "tf32": False}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PB.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not tops & {"jax", "jaxlib", "flax", "orbax", "iris_tts_tpu"}
    if path.startswith("perfbench/reference/"):
        assert "iris_tts_tpu_torch" not in tops
