"""Roofline analysis: three terms per (arch x shape x mesh) from the dry run
-- the twin of the reference's ``repro/launch/roofline.py``, term for term,
with the H100's denominators (``launch.mesh``):

    compute term    = FLOPs / (cards x 989e12)          [dense bf16 peak, H100 SXM]
    memory term     = HBM bytes / (cards x 3.35e12)
    collective term = collective bytes / 50e9           [one card's inter-node port]

Sources:

- FLOPs and HBM bytes: the analytic cost model (``launch.costs``), as in
  the reference.  The dry run's traced per-device FLOPs are reported
  alongside under the reference's key (``hlo_flops_per_dev_body_once``),
  but the port's trace is unrolled: every layer and the remat recompute
  are counted, not a loop body once.
- Collective bytes: the dry run's per-device count (``CollectiveCounter``);
  its "body" bucket is empty (no loop in an unrolled trace), so the
  reference's trip multiplier applies to nothing.  Both axes of the pod
  span nodes of 8 cards, so the denominator is ``mesh.LINK_BW``, the
  per-card InfiniBand figure, not NVLink's.

Also reported per cell: the dominant term, MODEL_FLOPS = 6ND / 2ND / 2N_act
per kind, the usefulness ratio MODEL_FLOPS / analytic FLOPs, whether the
peak fits the card's memory (``HBM_PER_CHIP``, the H100's 80 GB as torch
reports it), and a one-line "what would move the dominant term" note.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun experiments/dryrun \\
        --mesh 16x16 --out experiments/roofline.md
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

from repro_torch.configs.registry import get_config, get_shape
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.costs import step_cost
from repro_torch.models.model_zoo import model_flops

HBM_PER_CHIP = meshlib.HBM_BYTES  # H100 80GB HBM3


def _scan_trip_count(arch: str, kind: str, accum: int) -> int:
    """Trip count multiplier for loop-body collectives (the reference's)."""
    cfg = get_config(arch)
    if cfg.family == "ssm":
        layers = cfg.num_layers // 2
    elif cfg.family == "moe" and cfg.first_dense:
        layers = cfg.num_layers - 1
    elif cfg.family == "encdec":
        layers = cfg.num_layers + cfg.encoder_layers  # two scans; upper bound
    else:
        layers = cfg.num_layers
    return layers * (accum if kind == "train" else 1)


def analyze_record(rec: dict) -> dict:
    """Roofline-classify one dry-run record (compute / memory / collective bound)."""
    arch, shape_name = rec["arch"], rec["shape"]
    cfg = get_config(arch)
    if rec.get("cfg_overrides"):
        cfg = dataclasses.replace(cfg, **rec["cfg_overrides"])
    shape = get_shape(shape_name)
    chips = rec["devices"]
    accum = rec.get("accum_steps", 1)

    cost = step_cost(cfg, shape, accum_steps=accum)
    t_compute = cost.flops / (chips * meshlib.PEAK_FLOPS_BF16)
    t_memory = cost.hbm_bytes / (chips * meshlib.HBM_BW)

    cs = rec.get("collective_bytes_structured")
    if cs:
        trips = _scan_trip_count(arch, shape.kind, accum)
        coll_dev = cs["top"].get("total", 0) + cs["body"].get("total", 0) * trips
    else:
        coll_dev = rec["collective_bytes"].get("total", 0)
    # The counted bytes are this rank's already.
    t_coll = coll_dev / meshlib.LINK_BW

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / max(cost.flops, 1.0)
    bound = max(terms.values())
    frac = (mf / (chips * meshlib.PEAK_FLOPS_BF16)) / max(bound, 1e-30)  # useful compute time / bound time
    peak_mem = rec["memory"]["peak_bytes_est"]
    return {
        **{k: rec[k] for k in ("arch", "shape", "kind", "mesh", "devices")},
        "accum": accum,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "analytic_flops": cost.flops,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "hlo_flops_per_dev_body_once": rec["flops_per_device"],
        "peak_mem_gib": peak_mem / 2**30,
        "fits_hbm": peak_mem <= HBM_PER_CHIP,
        "advice": _advice(dominant, cfg, shape),
    }


def _advice(dominant: str, cfg, shape) -> str:
    if dominant == "compute":
        if cfg.family == "moe":
            return "compute-bound: cut capacity-factor slack / drop remat to 'dots'"
        return "compute-bound: near roofline ceiling; reduce remat recompute"
    if dominant == "memory":
        if shape.kind == "decode":
            return "KV/weight streaming bound: quantize KV to int8, batch more decode streams"
        return "activation traffic bound: increase accumulation, fuse norms, blockwise CE"
    return "collective-bound: overlap per-layer all-gathers with compute; shrink grad payload (int8 EF)"


def load_records(dryrun_dir: str, mesh: str) -> list[dict]:
    """Load every dry-run JSON record for ``mesh`` from ``dryrun_dir``."""
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, f"*_{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def to_markdown(rows: list[dict]) -> str:
    """Render analyzed roofline rows as a markdown table."""
    hdr = (
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | "
        "dominant | MODEL/HLO | roofline frac | peak mem (GiB) | fits |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['peak_mem_gib']:.1f} | {'Y' if r['fits_hbm'] else 'N'} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> None:
    """CLI: aggregate dry-run records into a roofline report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = [analyze_record(r) for r in load_records(args.dryrun, args.mesh)]
    md = to_markdown(rows)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        with open(args.out.replace(".md", ".json"), "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
