"""On the card: the energy counter reads the card and rises under work, and
one short run of a scoring cell prints a correct result line."""

import json
import subprocess
import sys

import pytest
import torch

from bench.tests.conftest import ROOT


@pytest.mark.cuda
def test_energy_counter_rises(card):
    from bench.energy import EnergyCounter

    counter = EnergyCounter(card)
    e0 = counter.read()
    x = torch.randn(8192, 8192, device=card, dtype=torch.bfloat16)
    for _ in range(200):
        x = torch.tanh(x @ x)
    torch.cuda.synchronize(card)
    import time

    time.sleep(0.3)
    assert counter.read() > e0
    counter.close()


@pytest.mark.cuda
def test_short_run_is_correct(card):
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "internlm2-1.8b.score_16x1k", "--seed",
                           str(2**31 + 99), "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
