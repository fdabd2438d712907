"""The port's example twins (``examples_torch/``) against the reference's
examples (``examples/``), on the CPU.

Each twin runs with ``--device cpu`` and the reference example runs beside
it, both through ``runpy`` in the same test; every number the twin prints
must lie within 1e-5 of the scale (the largest printed magnitude, at
least 1) of the reference's number at the same place.  ``serve_energy``
serves real models and prints measured wall-clock latencies, which no two
runs share: its twin is held to the reference's pinned scenario and to
serving and metering every architecture of it.
"""

import re
import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _run(path: Path, argv: list, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    capsys.readouterr()
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "stream_energy", "capped_cluster"])
def test_example_twin_prints_the_reference_figures(name, capsys, monkeypatch):
    got = _run(ROOT / "examples_torch" / f"{name}.py", ["--device", "cpu"], capsys, monkeypatch)
    want = _run(ROOT / "examples" / f"{name}.py", [], capsys, monkeypatch)
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want)  # the same text around the numbers
    g, w = ([float(x) for x in NUMBER.findall(out)] for out in (got, want))
    assert len(g) == len(w) > 10
    scale = max(1.0, max(abs(x) for x in w))
    worst = max(abs(a - b) for a, b in zip(g, w))
    assert worst <= 1e-5 * scale, (worst, scale)


def test_serve_energy_twin_serves_the_reference_scenario(capfd, monkeypatch):
    ref_src = (ROOT / "examples" / "serve_energy.py").read_text()
    twin = ROOT / "examples_torch" / "serve_energy.py"
    pinned = ["--archs", "internlm2-1.8b,xlstm-350m,olmoe-1b-7b", "--requests", "24", "--batch", "2",
              "--seq", "64", "--gen-steps", "4"]
    for arg in pinned:
        assert f'"{arg}"' in ref_src and f'"{arg}"' in twin.read_text(), arg
    monkeypatch.setattr(sys, "argv", [str(twin), "--device", "cpu"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(twin), run_name="__main__")
    assert done.value.code == 0
    out = capfd.readouterr().out
    assert "== serving 24 requests ==" in out and "real compute on cpu" in out
    for name in ("internlm2-1.8b", "xlstm-350m", "olmoe-1b-7b"):
        line = next(ln for ln in out.splitlines() if f"{name}/generate " in ln and "J/inv=" in ln)
        assert "usd/inv=" in line
