"""A CPU rehearsal of every cell, at the port's REDUCED sizes and a
one-second window, prints a well-formed result line, traced and not; the
command itself refuses to run without a card; a run whose timed path is
broken underneath comes out not correct; and so does a run with the
control, the plain reference in fp8, put in the program's place."""

import json
import subprocess
import sys

import pytest
import torch

from bench import harness
from bench.tests.conftest import ROOT, small_cell

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _run(cell, trace, capsys, seed=2**31 + 11):
    result = harness.run_cell(cell, seed, 1.0, trace, torch.device("cpu"), 0.0)
    harness.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert err.strip().splitlines()[-1].startswith("correct ")
    return line


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_line(name, trace, capsys):
    cell = small_cell(name)
    line = _run(cell, trace, capsys)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    if trace:
        assert dev["window_s"] > 0 and dev["busy_s"] == 0.0 and "breakdown" in line
        assert line["metrics"] == {}  # no device operation on the CPU: no device metric
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end} - {"card_j_per_inv"}
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _broken_scoring(monkeypatch, fault):
    from repro_torch.serving.engine import ServeEngine

    real = ServeEngine.prefill

    def prefill(self, batch, **kw):
        logits, cache = real(self, batch, **kw)
        if fault == "answer":
            logits = logits.clone()
            logits[..., 7] += logits.abs().max()
        elif fault == "cache":
            cache = dict(cache, v=cache["v"].clone())
            cache["v"][-1, :, -1] *= 2.0
        elif fault == "half_batch":
            half = batch["tokens"].shape[0] // 2
            part, part_cache = real(self, {"tokens": batch["tokens"][:half]}, **kw)
            logits = torch.cat([part, part], dim=0)
            cache = {k: torch.cat([v, v], dim=1) for k, v in part_cache.items()}
        return logits, cache

    monkeypatch.setattr(ServeEngine, "prefill", prefill)


@pytest.mark.parametrize("fault", ["answer", "cache", "half_batch"])
@pytest.mark.parametrize("name", ["granite-3-8b.score_4k", "internlm2-1.8b.score_16x1k"])
def test_scoring_faults_fail(name, fault, monkeypatch, capsys):
    cell = small_cell(name)
    if fault == "half_batch" and cell.traffic["batch"] < 2:
        pytest.skip("one prompt a call: no half of a batch to leave out")
    _broken_scoring(monkeypatch, fault)
    assert _run(cell, False, capsys)["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_fail(fault, monkeypatch, capsys):
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step

    if fault == "unchanged":
        real = opt.update

        def update(grads, state, params, config):
            moved = {id(p): p.detach().clone() for p in params.parameters()}
            out = real(grads, state, params, config)
            with torch.no_grad():
                for p in params.parameters():
                    p.copy_(moved[id(p)])
            return out

        monkeypatch.setattr(opt, "update", update)
    else:
        real_make = train_step.make_train_step

        def make(*a, **kw):
            step = real_make(*a, **kw)
            return lambda state, batch: step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

        monkeypatch.setattr(train_step, "make_train_step", make)
    assert _run(small_cell("internlm2-1.8b.train_4x2k"), False, capsys)["correct"] is False


@pytest.mark.parametrize("name", ["granite-3-8b.score_4k", "internlm2-1.8b.score_16x1k"])
def test_scoring_control_fails(name, monkeypatch, capsys):
    """Every invocation answered by the fp8 reference over the weights the
    run drew: the run's own comparison finds it out."""
    from bench import judge, system
    from repro_torch.serving.engine import ServeEngine

    cell = small_cell(name)
    drawn = {}
    draw = system.draw_weights

    def draw_weights(*args):
        drawn["weights"] = draw(*args)
        return drawn["weights"]

    def prefill(self, batch, **kw):
        return judge.reference_outputs(cell.reference, drawn["weights"], cell.model, batch["tokens"], "fp8")

    monkeypatch.setattr(system, "draw_weights", draw_weights)
    monkeypatch.setattr(ServeEngine, "prefill", prefill)
    line = _run(cell, False, capsys)
    assert line["correct"] is False and line["attempted"] > 0


def test_training_control_fails(monkeypatch, capsys):
    """The compared steps' readings taken from the fp8 reference over the
    same weights and rows: the run's own comparison finds it out."""
    cell = small_cell("internlm2-1.8b.train_4x2k")
    driver = cell.driver
    real = driver.compared

    def compared(cell, api, seed, step, state, batches, *args):
        state, _, rec = real(cell, api, seed, step, state, batches, *args)
        start = driver._start(cell, api, seed, torch.device("cpu"))
        program = cell.reference.train(start, [(b["tokens"], b["labels"]) for b in batches], cell.model,
                                       cell.traffic["optimizer"], z_loss=cell.traffic["z_loss"], precision="fp8")
        return state, program, rec

    monkeypatch.setattr(driver, "compared", compared)
    line = _run(cell, False, capsys)
    assert line["correct"] is False and line["attempted"] > 0
