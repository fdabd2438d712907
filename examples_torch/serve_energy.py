"""End-to-end driver: energy-first SERVING of real models on the PyTorch
port (the paper's kind).

    PYTHONPATH=src python examples_torch/serve_energy.py [--device cpu]

The twin of ``examples/serve_energy.py``: three architectures (reduced
configs) run as FaaS function classes on ``--device`` (default ``cuda``)
-- real prefill + decode compute, wall-clock metered -- then the measured
invocation trace flows through telemetry simulation -> FaasMeter profiling
-> energy footprints -> pricing, the paper's Fig. 1 pipeline.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # The serve launcher is the real driver; this example pins a scenario.
    path = os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)
    return subprocess.call(
        [
            sys.executable, "-m", "repro_torch.launch.serve",
            "--archs", "internlm2-1.8b,xlstm-350m,olmoe-1b-7b",
            "--requests", "24", "--batch", "2", "--seq", "64", "--gen-steps", "4",
            "--device", args.device,
        ],
        env={**os.environ, "PYTHONPATH": path},
    )


if __name__ == "__main__":
    sys.exit(main())
