"""The harness: a cell of ``BENCHMARK.json`` resolved to its files by name,
run once by the driver its traffic names, and reported as the result line.

A cell's configuration is the file its manifest entry names
(``bench/configs/<config>.json``), whose ``family`` names the model family
(``bench/families/<family>.py``) and its plain reference
(``bench/reference/<family>.py``); its traffic is
``bench/traffic/<traffic>.json``, whose ``kind`` names the driver
(``bench/drivers/<kind>.py``, with ``run``, ``unit_flops`` and
``controls``); the limits of its comparison are ``bench/limits/<cell>.json``;
and each per-layer metric is a reader ``bench/metrics/<metric>.py`` whose
``read(window)`` returns the metric or None when the trace holds nothing
for it.  Each is found by its name alone, so a new family, kind, mix,
metric or cell is new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import torch

from bench import costs, judge

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"

#: Top-level modules that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(folder: str, name: str):
    """The module ``bench/<folder>/<name>.py``, loaded once a process."""
    key = f"bench.{folder}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self):
        return load("drivers", self.traffic["kind"])

    @property
    def family(self):
        return load("families", self.model["family"])

    @property
    def reference(self):
        return load("reference", self.model["family"])

    def facts(self, device: torch.device) -> dict:
        """What a per-layer reader knows of the cell besides the trace."""
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        return {"model": self.model, "traffic": self.traffic, "peaks": costs.PEAKS.get(kind),
                "unit_flops": self.driver.unit_flops(self.family, self.model, self.traffic),
                "compute": costs.PEAK_KEY_OF_DTYPE[self.model["as_run"]["compute_dtype"]]}


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest with its files read."""
    spec = spec or manifest()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=w["chips"], model=_read(ROOT / config["file"]),
                traffic=_read(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=_read(BENCH / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    return load("metrics", metric).read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float) -> dict:
    """One run of the cell: the result line's object, ``checks`` last."""
    out = cell.driver.run(cell, seed & (2**64 - 1), seconds, trace, device, t_start)
    correct, checks = judge.verdict(out["numbers"], cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"])(out["window"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if trace:
        window = out["window"]
        dev["busy_s"], dev["window_s"] = window.busy_s, window.seconds
        result["breakdown"] = window.breakdown()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def report(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
