"""The manifest resolves to its files by name, keeps to the names its
format allows, and nothing under ``bench/`` imports JAX or the JAX
package; the reference imports nothing of the port."""

import ast
import json
import re

import pytest

from bench import harness
from bench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_manifest_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert all(m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell, SPEC)
    assert callable(c.driver.run) and callable(c.driver.unit_flops) and callable(c.driver.controls)
    assert callable(c.family.port_fields) and callable(c.reference.prefill)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert all(isinstance(v, float) for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    """The file holds the published values at its top level and the run's
    under ``as_run``; ``reduced`` names exactly the keys where they differ."""
    model = json.loads((ROOT / config["file"]).read_text())
    assert model["name"] == config["name"] and model["source"] == config["source"] and model["assumed"]
    run = model["as_run"]
    differ = sorted(k for k in run if k in model and run[k] != model[k])
    assert sorted(config["reduced"]) == differ
    assert not set(config["reduced"]) & {k for k in model if k.endswith(("_size", "_dim", "_heads"))}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted((ROOT / "bench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package(path):
    found = set(_imports(path)) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"
    if "reference" in path.parts:
        assert "repro_torch" not in set(_imports(path)) and "bench" not in set(_imports(path))
    assert "benchmarks/" not in path.read_text() or path.name.startswith("test_")


def test_forbidden_names_compare_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "repro_torch", sys)
    monkeypatch.setitem(sys.modules, "reprox", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro.core"]
