"""Shared fixtures of the benchmark's own tests: the repository's ``src``
and root on the path, the chip fixture, and small copies of the cells."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: The port's REDUCED sizes of both configurations.
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             intermediate_size=128, vocab_size=256)


@pytest.fixture
def card():
    """The CUDA card, or a skip when the machine has none (decided here, not
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


#: Limits for the training cell at the REDUCED sizes, where two layers of
#: width 64 over 64 tokens read bf16's gaps larger than the full cell does
#: (a sound CPU run: loss 3.2e-4, first gradient 4.4e-3, change 1.4e-3;
#: half of each batch left out: 0.035, 0.18, 0.24; a state left unchanged
#: reads 1 on the change).  The scoring cells keep their committed limits.
SMALL_TRAIN_LIMITS = {"loss_err": 2e-3, "grad_err": 2e-2, "change_err": 1e-2}


def small_cell(name: str):
    """The cell ``name`` at the port's REDUCED sizes with a small traffic."""
    from bench import harness

    cell = harness.load_cell(name)
    model = {**cell.model, **SMALL, "port": {"arch": cell.model["port"]["arch"], "reduced": True}}
    if "attention_multiplier" in model["as_run"]:  # 1 / sqrt(head_dim) as run
        model["as_run"] = {**model["as_run"], "attention_multiplier": SMALL["head_dim"] ** -0.5}
    t = dict(cell.traffic)
    if t["kind"] == "score":
        t.update(prompt_tokens=48, batch=min(t["batch"], 4), pool=8, check={"requests": 2, "within": 4})
    else:
        t.update(seq=32, batch=2, pool=8, remat="none")
        cell.limits = dict(SMALL_TRAIN_LIMITS)
    cell.model, cell.traffic = model, t
    return cell
