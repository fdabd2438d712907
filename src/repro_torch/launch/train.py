"""Training launcher: ``--arch <id> [--reduced] --steps N`` -- the twin of
the reference's ``repro/launch/train.py``.

Trains one architecture with the reference's flags and defaults, plus
``--device`` (default ``cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --reduced \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

``--mesh local`` (the default) builds (n, 1) ("data", "model") over the
process group's ranks (one rank in a single process, which makes its own
group); ``pod`` and ``multipod`` build the reference's (16, 16) and
(2, 16, 16) meshes and raise unless the group has 256 or 512 ranks
(``launch.mesh``).  As in the reference, the state is placed by
``state_shardings`` under ``TRAIN_RULES``, the batches by
``batch_shardings``, and the step runs inside ``use_rules(mesh,
TRAIN_RULES)``.  Weights come from a seeded ``torch.Generator`` on the
device, batches from ``data.pipeline.batch_iterator`` (the reference's
synthetic stream).  With ``--ckpt-dir`` a run checkpoints every
``--ckpt-every`` steps and at the end, and a relaunch resumes from the
newest complete checkpoint, re-placed on the mesh.  The reference's TPU XLA
flags have no twin.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, process_group
from repro_torch.models.model_zoo import build
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import (
    TrainState, batch_shardings, init_state, make_train_step, place_state, state_shardings,
)
from repro_torch.training.trainer import Trainer, TrainerConfig, TrainerReport


def _log_step(i: int, m: dict) -> None:
    if i % 10 == 0:
        print(f"step {i:5d} loss={float(m['loss']):.4f} lr={float(m.get('lr', 0)):.2e} t={m['step_time_s']:.3f}s",
              flush=True)


def main(argv: list[str] | None = None) -> tuple[TrainerReport, TrainState]:
    """CLI: a short training run of one architecture; returns the run's
    report and final state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", choices=["local", "pod", "multipod"], default="local")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    api = build(get_config(args.arch, reduced=args.reduced))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    ocfg = opt.OptimizerConfig(
        learning_rate=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        compress_grads=args.compress_grads,
    )
    with process_group(dev.type):
        mesh = {
            "local": lambda: make_local_mesh(dev.type),
            "pod": lambda: make_production_mesh(multi_pod=False, device_type=dev.type),
            "multipod": lambda: make_production_mesh(multi_pod=True, device_type=dev.type),
        }[args.mesh]()
        rules = shd.TRAIN_RULES
        st_sh = state_shardings(api, ocfg, mesh, rules)
        b_sh = batch_shardings(api.train_inputs(shape), mesh, rules)
        with shd.use_rules(mesh, rules):
            state = place_state(init_state(api, torch.Generator(device=dev).manual_seed(args.seed), ocfg), st_sh)
            trainer = Trainer(
                make_train_step(api, ocfg, accum_steps=args.accum),
                state,
                lambda start: batch_iterator(api, shape, DataConfig(seed=args.seed), start_step=start,
                                             shardings=b_sh),
                TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                              checkpoint_dir=args.ckpt_dir, log_every=10),
                state_shardings=st_sh,
                on_step=_log_step,
            )
            report = trainer.run()
    print(f"done: {report.steps_run} steps, final loss {report.final_loss:.4f}, "
          f"resumed_from={report.resumed_from}, stragglers={report.straggler_steps}")
    return report, trainer.state


if __name__ == "__main__":
    main()
