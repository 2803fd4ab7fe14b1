"""BENCHMARK.json against the contract's rules that the files can show,
and the harness's check of loaded modules by whole top-level names."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from kb_tiny import REPO
from kssd_bench import run

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = REPO / "kssd_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]]
             + [w["name"] for w in MANIFEST["workloads"]]
             + [m["name"] for m in _metrics()]
             + [w[k] for w in MANIFEST["workloads"]
                for k in ("config", "traffic")]
             + [k for c in MANIFEST["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in MANIFEST[kind]]
        assert len(set(got)) == len(got)
    got = [m["name"] for m in _metrics()]
    assert len(set(got)) == len(got)
    assert all(UNIT.match(m["unit"]) for m in _metrics())
    assert all(m["better"] in ("lower", "higher") for m in _metrics())
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_file_is_found_by_name():
    for c in MANIFEST["configs"]:
        f = REPO / c["file"]
        assert f.is_file() and f.is_relative_to(BENCH)
        assert json.loads(f.read_text())["name"] == c["name"]
    for w in MANIFEST["workloads"]:
        assert (BENCH / "configs" / f"{w['config']}.json").is_file()
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "runners" / f"{traffic['runner']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in _metrics():
        mod = run.load_file(BENCH / "metrics" / f"{m['name']}.py",
                            f"kb_manifest_{m['name']}")
        assert callable(mod.read)


def test_each_per_layer_metric_moves_a_metric_of_its_cells():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells)
           for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]]
    for w in cells:
        assert w in e2e["setup_s"]
        assert sum(w in v for v in e2e.values()) >= 2
        assert any(w in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])


def test_bounds_and_run_seconds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = 24
    assert 2 + 14 * cells * (MANIFEST["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200 <= 43200


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            got.add(node.module.partition(".")[0])
    return got


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imported_by_the_benchmark(path):
    got = _imports(path)
    assert not got & run.FORBIDDEN, got
    if "reference" in path.parts:
        assert "metakssd_tpu_torch" not in got


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "metakssd_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metakssd_tpu.formats", object())
    assert run.forbidden_modules() == ["metakssd_tpu"]
