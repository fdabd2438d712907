"""Train an assigned architecture with fault tolerance, then price the run.

    PYTHONPATH=src python examples_torch/train_energy.py [--device cpu]

The twin of ``examples/train_energy.py``: trains reduced xlstm-350m for 60
steps on ``--device`` (default ``cuda``) with checkpointing every 20 steps
under the temporary directory (kill it anytime; re-running resumes from the
newest checkpoint, bit-identically where the device's arithmetic is
deterministic), then converts the run's step times into energy with the
reference example's chip power figures and prices it (cost and carbon)
with the port's ``core.pricing``: energy as a first-class training metric.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.pricing import carbon_footprint_g, energy_price_usd
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import init_state, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

CHIP_IDLE_W, CHIP_DYN_W, MFU_GUESS = 60.0, 160.0, 0.35


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("xlstm-350m", reduced=True)
    api = build(cfg)
    shape = ShapeConfig("t", 128, 8, "train")
    ocfg = opt.OptimizerConfig(total_steps=60, warmup_steps=6)
    state = init_state(api, torch.Generator(device=dev).manual_seed(0), ocfg)

    trainer = Trainer(
        make_train_step(api, ocfg), state,
        lambda s: batch_iterator(api, shape, DataConfig(seed=0), start_step=s, device=dev),
        TrainerConfig(total_steps=60, checkpoint_every=20,
                      checkpoint_dir=os.path.join(tempfile.gettempdir(), "repro_torch_train_energy")),
        on_step=lambda i, m: print(f"step {i:3d} loss={float(m['loss']):.4f}") if i % 10 == 0 else None,
    )
    t0 = time.time()
    report = trainer.run()
    wall = time.time() - t0
    print(f"\n{report.steps_run} steps, final loss {report.final_loss:.4f}, "
          f"resumed_from={report.resumed_from}, stragglers={report.straggler_steps}")

    # Energy accounting for the run: the reference example's chip power
    # model (idle + dynamic at a guessed utilisation over the busy time).
    busy = sum(report.step_times)
    energy_j = CHIP_IDLE_W * wall + CHIP_DYN_W * MFU_GUESS * busy
    usd = float(energy_price_usd(torch.tensor(energy_j)))
    co2 = float(carbon_footprint_g(torch.tensor(energy_j)))
    print(f"run energy ~{energy_j:.0f} J  ->  ${usd:.6f}  /  {co2:.3f} gCO2 "
          f"({energy_j / max(report.steps_run, 1):.1f} J/step)")


if __name__ == "__main__":
    main()
