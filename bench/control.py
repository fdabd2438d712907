"""Readings on the chip from which a cell's limits are set, in one process.

    python3 bench/control.py --workload <cell> --seeds 11,12,... --control-seeds 21,22,23 [--seconds 3]

For each of ``--seeds``: one run of the cell as ``run.py`` makes it, with a
short window, and the numbers it compares (the program's readings: the
lower end of each limit).  For each of ``--control-seeds``, on that seed's
inputs at the cell's own sizes, the readings of the cell's driver
(``controls`` of ``bench/drivers/<kind>.py``): ``control_fp8``, the plain
reference computed in fp8 (every product's operands, the stored cache, and
in training the gradients) put in the program's place, which has to fail
(the upper end); and the faults the driver reads besides.  Prints one JSON
line a reading, with the verdict that the cell's limits give it.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]

    import torch

    from bench import harness, judge

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result = harness.run_cell(cell, seed, args.seconds, False, device, t0)
        nums = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"cell": cell.name, "seed": seed, "reading": "program", "numbers": nums,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        for reading, nums in cell.driver.controls(cell, seed, device):
            print(json.dumps({"cell": cell.name, "seed": seed, "reading": reading, "numbers": nums,
                              "correct": judge.verdict(nums, cell.limits)[0], "s": time.perf_counter() - t0}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
