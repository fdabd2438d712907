"""Fault-tolerant training loop: checkpoint/restart, straggler watchdog,
metrics -- the twin of the reference's ``repro/training/trainer.py``.

- **Auto-resume**: on start the trainer restores the newest *valid*
  checkpoint into its state (a crash mid-save leaves no complete manifest,
  so a damaged tail checkpoint is skipped) and the data iterator seeks to
  the restored step: a killed job relaunches bit-identically where the
  device's arithmetic is deterministic (the CPU's is).
- **Async checkpointing**: the device-to-host snapshot is synchronous, the
  filesystem write overlaps the next steps.  The run ends with the last
  step committed: written then, or, when the checkpoint cadence has just
  written it, waited for (the reference writes that step a second time,
  which on one card's disk is one full state more in flight: 22.7 GB for
  internlm2-1.8b).
- **Straggler watchdog**: each step's wall time against the running median
  of the last 50; a step beyond ``watchdog_factor`` times it is counted.
- The loss is read to the host once a step (the reference's
  ``device_get``): that read is also where a step's wall time ends.
- **Elastic re-shard**: with ``state_shardings`` the restore places the
  checkpoint's whole leaves onto that tree (``distributed.checkpoint``),
  whatever mesh the checkpoint was written under.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.training.train_step import TrainState


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0   # step > factor x median => straggler
    watchdog_warmup: int = 5       # ignore the first steps (warm-up)


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    resumed_from: int | None = None
    straggler_steps: int = 0
    losses: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


class Trainer:
    """Step-loop driver: data iterator, checkpoint/resume, straggler watchdog."""

    def __init__(
        self,
        step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]],
        init_state: TrainState,
        data_iter_factory: Callable[[int], Iterator[dict]],
        config: TrainerConfig = TrainerConfig(),
        *,
        state_shardings: Any = None,
        on_step: Callable[[int, dict], None] | None = None,
    ):
        self.step_fn = step_fn
        self.state = init_state
        self.data_iter_factory = data_iter_factory
        self.config = config
        self.on_step = on_step
        self._shardings = state_shardings
        self.ckpt = CheckpointManager(config.checkpoint_dir, keep=config.keep_checkpoints) \
            if config.checkpoint_dir else None

    def run(self) -> TrainerReport:
        cfg = self.config
        report = TrainerReport()
        start = 0
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(self.state, shardings=self._shardings)
            if restored is not None:
                start, self.state = restored
                report.resumed_from = start
        data = self.data_iter_factory(start)

        times: list[float] = []
        saved = None
        for step in range(start, cfg.total_steps):
            batch = next(data)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report.steps_run += 1
            report.losses.append(loss)
            report.step_times.append(dt)

            if len(times) >= cfg.watchdog_warmup and dt > cfg.watchdog_factor * float(np.median(times[-50:])):
                report.straggler_steps += 1
            times.append(dt)

            if self.on_step is not None:
                self.on_step(step, {**metrics, "step_time_s": dt})
            if self.ckpt is not None and (step + 1) % cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, self.state)
                saved = step + 1
        if self.ckpt is not None:
            if saved == cfg.total_steps:
                self.ckpt.wait()
            else:
                self.ckpt.save(cfg.total_steps, self.state, blocking=True)
        return report
