"""The port's example twins (``examples_torch/``) against the reference's
examples (``examples/``), on the CPU.

Each twin runs with ``--device cpu`` and the reference example runs beside
it, both through ``runpy`` in the same test; every number the twin prints
must lie within 1e-5 of the scale (the largest printed magnitude, at
least 1) of the reference's number at the same place.  ``serve_energy``
serves real models and prints measured wall-clock latencies, which no two
runs share: its twin is held to the reference's pinned scenario and to
serving and metering every architecture of it.  ``train_energy`` trains
from a ``torch.Generator``'s weights, which the reference's ``jax.random``
draws cannot match: its twin is held to the reference example's log, a
falling loss, its checkpoints and resume, and the reference's pricing.
"""

import re
import runpy
import sys
from pathlib import Path

import numpy as np
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


def test_train_energy_twin_trains_resumes_and_prices(tmp_path, capsys, monkeypatch):
    """``train_energy``'s twin on the CPU: 60 steps of reduced xlstm-350m
    with the reference example's step log, a falling loss and checkpoints
    in the temporary directory; a second run resumes at 60 and trains no
    step; the energy line is the reference example's power model priced by
    the port's ``core.pricing``, which agrees with the reference's.  (The
    reference example's own losses are NaN from its first step at this
    shape: ``test_torch_train_families.py`` pins that to its SSD's
    gradient.)"""
    import tempfile

    import jax.numpy as jnp

    from repro.core.pricing import energy_price_usd as r_price

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    twin = ROOT / "examples_torch" / "train_energy.py"
    first = _run(twin, ["--device", "cpu"], capsys, monkeypatch)
    losses = [float(x) for x in re.findall(r"^step +\d+ loss=(\S+)$", first, re.M)]
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] < losses[0], first
    assert re.search(r"^60 steps, final loss \d+\.\d+, resumed_from=None, stragglers=\d+$", first, re.M), first
    assert sorted(p.name for p in (tmp_path / "repro_torch_train_energy").iterdir()) == [
        "step_00000020", "step_00000040", "step_00000060"]
    energy, usd, co2, per_step = (float(x) for x in re.search(
        r"run energy ~(\d+) J  ->  \$(\S+)  /  (\S+) gCO2 \((\S+) J/step\)", first).groups())
    assert abs(usd - float(r_price(jnp.asarray(energy)))) <= 1e-6 and abs(per_step - energy / 60) <= 0.1
    second = _run(twin, ["--device", "cpu"], capsys, monkeypatch)
    assert "0 steps, final loss nan, resumed_from=60" in second
