#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on past):

1. Device and build: requires CUDA, prints the card's name and power limit,
   switches TF32 off, builds every CUDA source of ``src/repro_torch`` at
   once (one nvcc each), prints each one's build time and ptxas report,
   and counts the tensor-core flash kernel's ``HGMMA`` and ``UTMALDG``
   instructions and the decode kernel's asynchronous loads (``LDGSTS`` or
   ``UTMALDG``) in their SASS (``cuobjdump``): none, or no ``cuobjdump``,
   fails the run.  The flash and decode plans' shared memory (and the
   decode tile) must be what the built kernels compute.
2. Kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at its main path's shapes and at ragged ones, in bf16 and fp32
   for the attention and RMSNorm kernels; per shape the kernel's, the plain
   version's and one PyTorch library call's device times (cold L2), the
   kernel's and the library call's warm back-to-back time per launch, and
   the memory/compute bound.  The decode and gram kernels must give the
   same bits on a second call.  Flash in bf16 at d 64/128 is the tensor-core
   kernel.  bf16 attention outputs are held per row against the reference
   row's scale, and at the main shapes a planted one-key-tile fault must
   fail that check.
3. Fleet metering path: the paper's Table 2 functions (7 + the
   control-plane principal, M = 8) on 64 server nodes x 1800 s (paper §6
   segments, delta 1 s, N_init 100, N_K 60, so S = 28) through
   ``fleet_profile_batched`` and ``run_fleet_gram`` (the ``disagg_gram``
   kernel) against ``run_fleet``; replayed under torch.profiler; then the
   same profiling on 3 nodes x 300 s on the card and on the CPU (1e-5 of
   scale); a second ``fleet_profile_batched`` call gives the same bits.
4. Streaming control plane (no hand kernel is on this path, as in the
   reference; every kernel count must stay 0): on the fleet phase's
   packed inputs, ``run_fleet_stream`` against ``run_fleet`` (1e-5 of
   scale, per-tick power 1e-4) and a tick-at-a-time ``fleet_step`` loop
   against it (bitwise), with the per-tick cost against the segment
   engine's amortised one (``seg_us_per_tick``, ``stream_us_per_tick``,
   ``overhead_ratio``); a hookless ``start_fleet_stream`` session from its
   first engine tick to its last under
   ``torch.cuda.set_sync_debug_mode("error")``, its buffers' storage
   unchanged, and its reports against the same session on the CPU;
   ``EnergyFirstControlPlane.profile_fleet`` on the 64 x 1800 s fleet
   with ``prefetch=0``, ``prefetch=2`` and ``drain=True`` (ticks/s each,
   conservation on every tick, reports against ``fleet_profile_batched``,
   the three runs equal bitwise); 3 nodes x 300 s on the card and the
   CPU (1e-5 of scale); 120 ticks of a session under torch.profiler.
5. Combined metering (§4.3, the chip side from counter models, the rest
   disaggregated): on the fleet phase's fleet, ``prepare_combined_fleet``
   and ``fleet_profile_batched(mode="combined")`` twice on the card (the
   same bits) and once on the CPU (1e-5 of scale), efficiency 1e-5;
   ``profile_fleet(mode="combined")`` (ticks/s, conservation on every tick
   to 1e-3 W, skew and Total-Error against the batched path within PR 15's
   bounds); a hookless combined session with retrain checks under
   ``set_sync_debug_mode("error")``, its buffers, models and ``x_cpu``
   unmoved; a server/desktop/edge fleet whose chipless row equals the pure
   path's; the combined target through ``run_fleet_gram`` and ``run_fleet``
   (every tick conserved, 1e-5); and the reference's
   ``benchmarks/combined_fleet.py`` metrics at the controller shape
   (B 64 x S 4 x n_w 60 x M 128), its combined target through
   ``run_fleet_gram`` (the gram kernel at M = 128) against ``run_fleet``.
6. Closed control loop: ``profile_fleet(mode="combined",
   control=ControlLoop(...))`` at ``benchmarks/control_loop.py``'s
   acceptance shape (4 nodes x 420 s, load 45, >= 1e5 invocations, cap at
   the 0.90 quantile), its controlled traces re-simulated: overshoot below
   the uncontrolled one, work conserved, starts only forward, two card
   replays equal bitwise; the hook's cost per tick, queue waits, and the
   admission decisions that differ from the CPU's; retraining after a x1.4
   chip drift recovering under 0.05; ``run_capped`` on one node.
7. Elastic serving, at the reference benchmarks' full sizes: the fleet
   phase's fleet made ragged (post-init lengths drawn in [N/4, N]) in
   ``DEFAULT_BUCKETS`` (8, 16 and 32 steps) and benchmarks/ragged_fleet.py's
   r50 fleet (B 64 x S 8 x n_w 60 x M 128) in buckets of 1-8 steps:
   ``run_fleet_bucketed`` with ``run_fleet`` and ``run_fleet_gram``
   against the same engine on the monolithic pack (1e-5 of scale) and the
   padding each pack wastes; the node-axis mesh on one card (a one-device
   mesh bitwise equal to mesh=None through ``run_fleet_gram``,
   ``run_fleet_stream`` and a tick-at-a-time ``fleet_step`` stream; a
   two-entry mesh over the same card at 1e-5 of scale; the totals against
   plain sums; a mid-stream ``reshard``); benchmarks/slot_serving.py's
   64-slot churn trace behind a ``SlotAdmissionQueue`` (ticks/s, tick
   latency, churn counts) with every release, admission and step under
   ``torch.cuda.set_sync_debug_mode("error")``, the pool's buffers unmoved
   and no kernel built after ``warmup()``, and the same trace on the CPU
   (1e-5 of scale); ``profile_fleet(slots=64)`` on a 64-node fleet of
   900-1,800 s, pure and combined, against ``profile_fleet`` without
   slots; the baseline profilers on the card against the CPU.  Then the
   gram kernel against its plain version at every shape that phase
   launched, on the inputs it launched them with.
8. Serving path: internlm2-1.8b at its full published width (random
   weights from a seeded generator, bf16 compute) serves 24 requests of two
   function classes (chat: batch 8, prompt 512, 64 tokens; summarize: batch
   2, prompt 4096, 16 tokens; 2:1) through ``MeteredServer`` and the flash
   and decode attention kernels; the measured trace is metered by the
   simulated telemetry and ``FaasMeterProfiler`` and priced.
9. RMSNorm path: ``ops.rmsnorm`` (the kernel) on the served model's final
   hidden states, against the model's plain ``rms_norm``.
10. Model consistency at full width: fp32 prefill vs full forward (2e-3)
   and one decode step vs the full forward over the extended sequence
   (5e-3), through the kernels; then 16 greedy steps with the kernels
   against the plain versions patched into ``ops`` here: equal tokens in
   fp32, and in bf16 the logits' distance from fp32 compute for both (the
   kernels' at most 1.5x the plain versions').
11. Trace: one warm chat and one warm summarize request under
   torch.profiler: device busy, idle share, top kernels; every
   ``decode_attention`` call must be one kernel on the device.
12. Model families, at full width from seeded random weights: the int8
   KV cache on the served internlm2 weights (the reference's pins: decode
   logits against the bf16 cache's, cosine > 0.999 and argmax equal;
   greedy tokens against it; cache bytes; 3 chat requests served, no
   decode kernel launched: the reference runs int8 decode as plain code);
   olmoe-1b-7b at full depth serving 12 requests of the two classes
   (traced: device busy per request), its fp32 invariants, kernels
   against plain versions and the share of routing choices bf16 and fp32
   make alike; deepseek-moe-16b cut to 4 layers (dense layer 0 + 3 MoE
   layers with shared experts), one prefill and 16 decode steps;
   xlstm-350m, 6 chat requests; internvl2-2b, 3 requests of 256 patch
   embeddings + 256 tokens; the fp32 prefill/decode invariants of each;
   one decode step of olmoe, xlstm and the int8 cache under
   ``torch.cuda.set_sync_debug_mode("error")``; then
   ``repro_torch.launch.serve``'s defaults (the reference's mix, reduced).
   Each path's flash and decode launches must be one per attention layer
   per prefill and per decode step.

Each path's kernel launch counts are zeroed just before it and read just
after (every bf16 flash launch of the serving paths must be a tensor-core
one); while the fleet, streaming, combined, control, elastic and serving
paths run, the plain versions are watched, and a CUDA tensor reaching one
fails the run (the launches that compare a kernel with its plain version
are outside those paths).

Output: one line per measurement, a ``combined_control {...}`` JSON line of
phases 5-6, an ``elastic {...}`` one of phase 7 and a ``families {...}``
one of phase 12, then a
``{"kernels": [...]}`` JSON line,
the ``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; no network.

``python3 chip_smoke.py --bench [DIR]`` runs only the decode and gram
kernel timings (``bench_main``), of this tree or another one.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# the fp32 rate outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
L2_ROTATE_BYTES = 125e6  # 2.5x the 50 MB L2: the warm rate's rotating copies read HBM

B_NODES, DURATION_S, PLATFORM = 64, 1800.0, "server"
N_INIT, N_K = 100, 60  # ProfilerConfig defaults (paper §6)
S_STEPS = (int(DURATION_S) - N_INIT) // N_K
MAIN_SHAPES = [(B_NODES * S_STEPS, N_K, 8), (B_NODES, N_INIT, 8)]  # step hoist, X_0
# M >= 64 takes the tiled kernel (M 65 and 33: rows not 16-byte aligned);
# N * M not a multiple of 4 (197 * 5, 130 * 17) makes the warp kernel's
# copies ragged.
# Combined mode's fleet-controller shape (benchmarks/combined_fleet.py:58:
# B 64 x S 4 x n_w 60 x M 128): run_fleet_gram's step hoist and X_0 grams.
COMBINED_SHAPE = (64, 4, 60, 128)
COMBINED_GRAM_SHAPES = [(64 * 4, 60, 128), (64, 4 * 60, 128)]
PARITY_SHAPES = MAIN_SHAPES + COMBINED_GRAM_SHAPES + [(64, 1800, 64), (8, 1000, 256), (4, 1, 5), (6, 197, 5),
                                                      (16, 130, 17), (4, 300, 65), (5, 257, 33)]
# Elastic serving, at the reference benchmarks' full sizes: the fleet
# phase's fleet made ragged (post-init lengths drawn in [N/4, N] windows,
# seed 0, node 0 at N) in DEFAULT_BUCKETS; benchmarks/ragged_fleet.py's
# r50 fleet (B 64 x S 8 x n_w 60 x M 128, buckets 1-8); and
# benchmarks/slot_serving.py's pool (capacity, M, n_w, horizon ticks,
# population).  profile_fleet(slots=) runs a 64-node fleet of durations
# drawn in [900, 1800] s (seed 0).
RAGGED_SHAPE = (64, 8, 60, 128)
RAGGED_BUCKETS = (1, 2, 4, 8)
SLOT_POOL = (64, 64, 60, 1200, 256)
SLOT_DURATIONS_S = (900, 1800)
# The bench's gram shapes: the main ones, M >= 64, M either side of the
# variants' threshold (16 and 17), and a long N at G = 1.
BENCH_GRAM = MAIN_SHAPES + [(64, 1800, 64), (8, 1000, 256), (16, 130, 16), (16, 130, 17), (1, 5000, 8)]

# Serving path: internlm2-1.8b (24 layers, 16 heads, 8 KV heads, head_dim
# 128, d_model 2048) as two function classes on one set of weights.
ARCH = "internlm2-1.8b"
CLASSES = {
    f"{ARCH}/chat": dict(batch=8, prompt=512, steps=64),
    f"{ARCH}/summarize": dict(batch=2, prompt=4096, steps=16),
}
SCHEDULE = [f"{ARCH}/chat", f"{ARCH}/chat", f"{ARCH}/summarize"] * 8  # 24 requests, 2:1
H, HKV, HD, D_MODEL = 16, 8, 128, 2048
# Kernel shapes of that path (flash: B, S, T, H, Hkv, d, causal; decode: B,
# S_max, lengths; RMSNorm: rows, d).  Decode is listed at each class's last
# step, the longest cache it reads.
FLASH_MAIN = [(8, 512, 512, H, HKV, HD, True), (2, 4096, 4096, H, HKV, HD, True)]
# Ragged flash shapes against the tensor-core kernel's 128-row query and
# 128-key tiles: S and T not tile multiples, S < T, S > T (rows with no live
# key give 0), not causal, groups 1, 2 and 4, d 64 and 128, grids of fewer
# blocks than SMs (B * H * ceil(S / 128) = 16 for the first); d 32 stays on
# the FMA kernel in bf16 too.
FLASH_RAGGED = [(1, 100, 333, H, HKV, HD, True), (2, 77, 77, H, HKV, HD, True),
                (1, 130, 130, H, HKV, HD, False), (3, 1000, 1000, H, 4, HD, True), (2, 45, 45, 4, 1, 64, True),
                (1, 300, 200, H, HKV, HD, True), (2, 150, 40, 4, 4, 64, True), (1, 300, 200, 8, 2, 64, False),
                (1, 200, 200, 8, 8, 64, True), (2, 45, 45, 4, 2, 32, True)]
DECODE_MAIN = [(8, 576, (575,) * 8), (2, 4112, (4111,) * 2)]
# One sequence over a long cache takes the largest cluster (8 slices).
DECODE_RAGGED = [(8, 576, (575, 1, 64, 65, 300, 2, 576, 129)), (3, 1000, (1, 999, 500)), (1, 4112, (4111,))]
RMS_MAIN = [(8 * 512, D_MODEL)]
RMS_RAGGED = [(4097, D_MODEL), (7, 33), (1, D_MODEL), (2 * 4096, D_MODEL), (1001, 4096), (4096, 4096)]

# Model families (the reference launcher's MoE and xLSTM models, the int8 KV
# cache, the VLM prefix), full width, random weights from a seeded generator.
# olmoe-1b-7b at full depth in internlm2's two classes (12 requests, 2:1);
# deepseek-moe-16b cut from 28 layers to 4 (dense layer 0 + 3 MoE layers:
# its 16.9 B parameters would take 34 GB in bf16 besides the fp32 masters);
# xlstm-350m in the chat class only (its sLSTM is a loop over time, so a
# 4,096-token summarize prompt is 49,152 sequential steps); internvl2-2b
# with 256 patch embeddings + 256 tokens; the int8 cache on internlm2-1.8b.
OLMOE = "olmoe-1b-7b"
OLMOE_CLASSES = {f"{OLMOE}/chat": CLASSES[f"{ARCH}/chat"], f"{OLMOE}/summarize": CLASSES[f"{ARCH}/summarize"]}
OLMOE_SCHEDULE = [f"{OLMOE}/chat", f"{OLMOE}/chat", f"{OLMOE}/summarize"] * 4  # 12 requests, 2:1
DEEPSEEK, DEEPSEEK_LAYERS = "deepseek-moe-16b", 4
DEEPSEEK_CLASS = dict(batch=8, prompt=512, steps=17)  # one prefill + 16 decode steps
XLSTM = "xlstm-350m"
XLSTM_CLASSES = {f"{XLSTM}/chat": CLASSES[f"{ARCH}/chat"]}
XLSTM_SCHEDULE = [f"{XLSTM}/chat"] * 6
VLM = "internvl2-2b"
VLM_CLASSES = {f"{VLM}/chat": dict(batch=4, prompt=512, steps=16)}  # prompt = 256 patches + 256 tokens
VLM_SCHEDULE = [f"{VLM}/chat"] * 3
INT8_CLASSES = {f"{ARCH}-int8/chat": CLASSES[f"{ARCH}/chat"]}
INT8_SCHEDULE = [f"{ARCH}-int8/chat"] * 3
# Attention shapes those paths add: olmoe and deepseek have H = Hkv = 16
# (GQA group 1) at d 128; internvl2 is H 16 over Hkv 8 at batch 4.
FLASH_MOE = [(8, 512, 512, 16, 16, HD, True), (2, 4096, 4096, 16, 16, HD, True)]
FLASH_VLM = [(4, 512, 512, H, HKV, HD, True)]
DECODE_MOE = [(8, 576, (575,) * 8), (2, 4112, (4111,) * 2)]  # at Hkv = 16
MOE_H = MOE_HKV = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def gram_work(g: int, n: int, m: int) -> tuple[float, float]:
    """(bytes, flops) of one gram assembly: inputs read once, outputs written
    once, 2 flops per multiply-add of the M(M+1)/2 unique entries of the
    symmetric C^T C and of C^T w, whatever computes them."""
    nbytes = 4.0 * (g * n * m + g * n + g * m * m + g * m)
    flops = 1.0 * g * n * m * (m + 1) + 2.0 * g * n * m
    return nbytes, flops


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn()`` in ms, L2 flushed before each run.

    A 128 MB write evicts the 50 MB L2, then a spin kernel keeps the GPU
    busy while the host enqueues the timed launch, so the events bracket
    device work only, not Python launch overhead.
    """
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def warm_ms(fn, args, nbytes: float, launches: int = 100) -> float:
    """Back-to-back device time per launch of ``fn(*args)`` in ms, rotating
    over enough copies of ``args`` that they exceed the L2 (each launch
    reads HBM, as in a serving loop).  A spin kernel holds the GPU while
    the host enqueues all ``launches``, so the two events time device work
    only, with no launch gaps."""
    copies = max(2, min(launches, math.ceil(L2_ROTATE_BYTES / max(nbytes, 1.0))))
    sets = [[a.clone() for a in args] for _ in range(copies)]
    for inputs in sets:
        fn(*inputs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(launches):
        fn(*sets[i % copies])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def _sdpa_with_lengths(q, kc, vc, lens):
    """SDPA's layout of decode's inputs, and a call that attends to the rows
    below each length: ``fn(*args)`` is the library twin of decode."""
    import torch.nn.functional as F

    mask = (torch.arange(kc.shape[1], device=kc.device)[None, :] < lens[:, None])[:, None, None, :]
    args = (q[:, :, None], kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous())
    return lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True), args


def time_decode(da, q, kc, vc, lens, warm: bool = False) -> dict:
    """Cold-L2 ms of ``da.decode_attention`` (any tree's module) and of SDPA
    with a length mask on the same inputs; with ``warm``, both warm
    back-to-back rates too."""
    sdpa, args = _sdpa_with_lengths(q, kc, vc, lens)
    row = dict(ms=device_ms(lambda: da.decode_attention(q, kc, vc, lens)), library_ms=device_ms(lambda: sdpa(*args)))
    if warm:
        nbytes = decode_work(q.shape[0], q.shape[1], kc.shape[2], q.shape[2], lens.tolist(), q.dtype)[0]
        row["warm_ms"] = warm_ms(da.decode_attention, (q, kc, vc, lens), nbytes)
        row["library_warm_ms"] = warm_ms(sdpa, args, nbytes)
    return row


def _bmm_gram(cw):
    return torch.bmm(cw.mT, cw)


def time_gram(ds, c, w, warm: bool = False) -> dict:
    """Cold-L2 ms of ``ds.disagg_gram`` (any tree's module) and of
    ``torch.bmm`` of [C, w]^T [C, w], which holds gram and rhs; with
    ``warm``, both warm back-to-back rates too."""
    cw = torch.cat([c, w[..., None]], dim=-1)
    row = dict(ms=device_ms(lambda: ds.disagg_gram(c, w)), library_ms=device_ms(lambda: _bmm_gram(cw)))
    if warm:
        nbytes = gram_work(*c.shape)[0]
        row["warm_ms"] = warm_ms(ds.disagg_gram, (c, w), nbytes)
        row["library_warm_ms"] = warm_ms(_bmm_gram, (cw,), nbytes)
    return row


def _sass_count(lib: Path, ops) -> dict:
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {op: sass.count(op) for op in ops}


def _cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, or the copy in Triton's package."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(found).exists():
        return found
    try:
        import triton
    except ImportError:
        triton = None
    if triton is not None:
        bundled = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        if bundled.exists():
            return str(bundled)
    raise RuntimeError("no cuobjdump (PATH, /usr/local/cuda/bin, triton/backends/nvidia/bin): cannot read the SASS")


def phase_build() -> float:
    """Compile every kernel at once (one nvcc each, each timed), load each,
    check that the tensor-core flash kernel's SASS holds wgmma (HGMMA) and
    TMA loads (UTMALDG) and the decode kernel's asynchronous copies
    (LDGSTS or UTMALDG), and that the plans' geometry is the kernels'."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention, disagg_solve, flash_attention, rmsnorm

    t0 = time.perf_counter()
    built = kbuild.compile_all(list(KERNELS))
    for mod in (disagg_solve, flash_attention, decode_attention, rmsnorm):
        mod.build()
    dt = time.perf_counter() - t0
    for name in KERNELS:
        nvcc_log, secs = built[name]
        log(f"  nvcc {name}.cu: {secs:.2f} s")
        for line in nvcc_log.strip().splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line or "spill" in line) \
                    or "bytes stack frame" in line or "warning" in line:
                log(f"  nvcc {name}: {line.strip()}")
    log(f"build: {', '.join(f'{k}.cu' for k in KERNELS)} -> sm_90a in {dt:.2f} s (parallel)")
    counts = _sass_count(kbuild.library_path("flash_attention_tc"), ("HGMMA", "UTMALDG"))
    log(f"sass flash_attention_tc: {counts}")
    assert all(counts.values()), f"the tensor-core flash kernel's SASS lacks wgmma or TMA loads: {counts}"
    counts = _sass_count(kbuild.library_path("decode_attention"), ("LDGSTS", "UTMALDG"))
    log(f"sass decode_attention: {counts}")
    assert any(counts.values()), f"the decode kernel's SASS has no asynchronous loads: {counts}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, smax, _ in DECODE_MAIN:
        for dtype in (torch.bfloat16, torch.float32):
            elem = _elem(dtype)
            dplan = decode_attention.decode_plan(b, H, HKV, smax, HD, elem, sms)
            built = decode_attention.kernel_geometry(HD, elem, dplan["group"])
            assert built == (dplan["tile"], dplan["smem_bytes"]), (b, smax, dtype, built, dplan)
            log(f"decode plan {str(dtype)[6:]} B={b} S_max={smax}: grid {dplan['grid']} in clusters of "
                f"{dplan['cluster']}, slices of {dplan['chunk']} keys in {dplan['tile']}-key tiles x "
                f"{dplan['stages']} stages, {dplan['smem_bytes']} B dynamic shared memory")
    for d in flash_attention.TC_HEAD_DIMS:
        plan = flash_attention.tc_plan(*FLASH_MAIN[-1][:5], d)
        assert flash_attention.tc_smem_bytes(d) == plan["smem_bytes"], (d, plan["smem_bytes"])
    log(f"flash tc plan at summarize: grid {plan['grid']} x {plan['threads']} threads, "
        f"{plan['smem_bytes']} B dynamic shared memory, {sum(plan['key_tiles'])} key tiles per (batch, head)")
    return dt


def gram_parity(ds, ref, c, w, warm: bool, label: str = "parity") -> dict:
    """One shape's gram row: the kernel twice (the same bits) and against
    its plain version on (c, w), its cold-L2 time against the plain
    version's and ``torch.bmm``'s (with ``warm``, the warm back-to-back
    rates too), and the bytes-or-operations bound."""
    g, n, m = c.shape
    gram, rhs = ds.disagg_gram(c, w)
    gram2, rhs2 = ds.disagg_gram(c, w)
    torch.cuda.synchronize()
    assert torch.equal(gram, gram2) and torch.equal(rhs, rhs2), f"disagg_gram not deterministic at {(g, n, m)}"
    pg, pr = ref.disagg_gram(c, w)
    # An N-term fp32 sum taken in another order: rtol 1e-5 plus an atol
    # of 1e-6 * N * max|C| * max(|C|, |w|).
    cmax = float(c.abs().max())
    atol = 1e-6 * n * cmax * max(cmax, float(w.abs().max()))
    err = max(float((gram - pg).abs().max()), float((rhs - pr).abs().max()))
    torch.testing.assert_close(gram, pg, rtol=1e-5, atol=atol)
    torch.testing.assert_close(rhs, pr, rtol=1e-5, atol=atol)
    timed = time_gram(ds, c, w, warm=warm)
    nbytes, flops = gram_work(g, n, m)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    plan = ds.gram_plan(g, n, m, torch.cuda.get_device_properties(0).multi_processor_count)
    row = dict(
        err=err, plain_ms=device_ms(lambda: ref.disagg_gram(c, w)), bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S else "operations",
        variant=plan["variant"], **timed,
    )
    warm_s = "".join(f" {k}={row[k]:.5f}" for k in ("warm_ms", "library_warm_ms") if k in row)
    log(
        f"{label} G={g} N={n} M={m} ({plan['variant']}): max_abs_err={err:.3e} (atol {atol:.3e}) "
        f"kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f}{warm_s} "
        f"bound_us={bound * 1e3:.3f} ({row['bound_by']}) bound_share={bound / row['ms']:.3f}"
    )
    return row


def phase_kernel_parity(ds, ref) -> dict:
    """Kernel vs plain on the card at every listed shape; returns the main
    shapes' timings."""
    rng = np.random.default_rng(0)
    rows = {}
    for g, n, m in PARITY_SHAPES:
        c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32)).cuda()
        w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).cuda()
        rows[(g, n, m)] = gram_parity(ds, ref, c, w, warm=(g, n, m) in MAIN_SHAPES or m >= 64)
    return rows


def _engine_inputs(traces, sims, device, n):
    """Per-node C (with the control-plane column, M = 8), A and the idle-
    adjusted power, packed into the main path's (B, S, N_K, 8) batch plus
    the N_INIT window X_0 block."""
    from repro_torch.core.contribution import (
        augment_with_principals,
        contribution_matrix,
        invocation_counts,
        shared_principal_contribution,
    )
    from repro_torch.core.engine import pack_fleet_inputs

    m = traces[0].num_fns
    cs, a_s, ws = [], [], []
    for tr, sim in zip(traces, sims):
        tel = sim.telemetry.to(device)
        fn_id = torch.as_tensor(tr.fn_id, dtype=torch.int64, device=device)
        start = torch.as_tensor(tr.start, device=device)
        end = torch.as_tensor(tr.end, device=device)
        cp = shared_principal_contribution(tel.cp_cpu_frac[:n], tel.sys_cpu_frac[:n])
        cs.append(augment_with_principals(
            contribution_matrix(fn_id, start, end, num_fns=m, num_windows=n), cp
        ))
        a = invocation_counts(fn_id, start, num_fns=m, num_windows=n)
        # The principal is always active: one pseudo-invocation per Kalman
        # step, on the step's first window (as the profiler counts it).
        first = ((torch.arange(n, device=device) - N_INIT) % N_K == 0).to(torch.float32)
        a_s.append(torch.cat([a, first[:, None]], dim=1))
        ws.append(torch.clamp(tel.system_power[:n] - tel.idle_watts, min=0.0))
    c, a, w = torch.stack(cs), torch.stack(a_s), torch.stack(ws)
    zeros = torch.zeros_like(a)
    inputs = pack_fleet_inputs(
        c[:, N_INIT:], w[:, N_INIT:], a[:, N_INIT:], zeros[:, N_INIT:], zeros[:, N_INIT:],
        step_windows=N_K, device=device,
    )
    return inputs, c[:, :N_INIT], w[:, :N_INIT]


def phase_main_path(device: str, b: int = B_NODES, duration: float = DURATION_S):
    """Drive the port's main path on ``device``.  Returns its checks and
    times, closures that replay its two engine calls for tracing, and the
    fleet (traces, simulations, packed engine inputs, batched reports) that
    the streaming phase reuses."""
    from repro_torch.core.engine import EngineConfig, run_fleet, run_fleet_gram
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
    from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    reg = paper_functions()
    t0 = time.perf_counter()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=duration, load=1.0), b)
    sims = NodeSimulator(reg, SimulatorConfig(platform=PLATFORM)).simulate_fleet(traces)
    out["simulate_s"] = time.perf_counter() - t0
    out["invocations"] = int(sum(t.num_invocations for t in traces))

    def profile():
        return fleet_profile_batched(
            FaasMeterProfiler(ProfilerConfig()),
            [(t.fn_id, t.start, t.end) for t in traces],
            [s.telemetry for s in sims],
            num_fns=len(reg), duration=duration, device=device,
        )

    t0 = time.perf_counter()
    reports = profile()
    sync()
    out["profile_s"] = time.perf_counter() - t0
    assert len(reports) == b, len(reports)
    errs, eff = [], []
    for rep, sim in zip(reports, sims):
        x = rep.x_power.cpu().numpy()
        assert rep.x_power.device.type == device and x.shape == (len(reg),)
        assert np.all(np.isfinite(x)) and np.all(x >= 0.0)
        assert np.all(np.isfinite(rep.x_trajectory.cpu().numpy()))
        total = float(rep.spectrum.j_indiv.sum()) + rep.cp_energy + rep.idle_energy
        eff.append(abs(float(rep.spectrum.j_total.sum()) - total) / total)
        truth = sim.true_fn_power_w
        ok = truth > 0
        errs.extend(np.abs(x[ok] - truth[ok]) / truth[ok])
    assert max(eff) <= 1e-5, max(eff)
    out["reports"] = len(reports)
    out["efficiency_max_rel_err"] = max(eff)
    out["median_footprint_err"] = float(np.median(errs))
    # The trace's statistics are summed on the host in a fixed order, so a
    # second call gives the same bits (CUDA's atomic index_add_ did not).
    t0 = time.perf_counter()
    again = profile()
    sync()
    out["profile_warm_s"] = time.perf_counter() - t0
    out["repeat_bitwise"] = _reports_equal(reports, again)
    assert out["repeat_bitwise"], "two fleet_profile_batched calls on the card differ"

    t0 = time.perf_counter()
    inputs, init_c, init_w = _engine_inputs(traces, sims, device, int(duration))
    sync()
    out["pack_s"] = time.perf_counter() - t0
    out["engine_shape"] = list(inputs.c.shape)
    cfg = EngineConfig()
    t0 = time.perf_counter()
    gram_res = run_fleet_gram(inputs, cfg, init_c=init_c, init_w=init_w, device=device)
    sync()
    out["run_fleet_gram_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_res = run_fleet(inputs, cfg, init_c=init_c, init_w=init_w, device=device)
    sync()
    out["run_fleet_s"] = time.perf_counter() - t0
    d = float((gram_res.x_final - raw_res.x_final).abs().max())
    out["gram_vs_raw_max_abs"] = d
    out["x_final_max"] = float(raw_res.x_final.abs().max())
    measured = inputs.w.reshape(b, -1)
    recon = gram_res.tick_power.sum(-1) + gram_res.unattributed
    cons = float((recon - measured).abs().max()) / float(measured.abs().max())
    out["conservation_rel"] = cons
    assert torch.isfinite(gram_res.x_trajectory).all()
    assert cons <= 1e-5, cons
    replays = {
        "fleet_profile_batched": (profile, out["profile_s"]),
        "run_fleet_gram": (
            lambda: run_fleet_gram(inputs, cfg, init_c=init_c, init_w=init_w, device=device),
            out["run_fleet_gram_s"],
        ),
    }
    fleet = dict(traces=traces, sims=sims, inputs=inputs, init_c=init_c, init_w=init_w,
                 reports=reports, duration=duration)
    return out, replays, fleet


def _device_events(prof) -> list:
    """(name, µs) of every device operation a ``torch.profiler`` trace
    recorded, read from its raw kineto events: ``prof.events()`` builds a
    Python event tree first, which took over a minute for one serving
    request of ~120,000 kernels."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() * 1e-3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def phase_trace(replays, kernel_calls=None) -> None:
    """Replay each main-path call warm, untraced and then under
    torch.profiler: device busy time is the sum of the traced run's CUDA
    kernel intervals (one stream, so they do not overlap), idle share is
    1 - busy / the warm untraced wall time.  ``kernel_calls`` maps a kernel
    name to a wrapper whose ``launches`` count the traced run must match
    one device kernel per call."""
    from torch.profiler import ProfilerActivity, profile

    for name, (fn, first_wall) in replays.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        before = {k: f.launches for k, f in (kernel_calls or {}).items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        kernels = _device_events(prof)
        if not kernels:
            log(f"trace {name}: no device events recorded; device busy share not measured")
            continue
        for kname, f in (kernel_calls or {}).items():
            calls = f.launches - before[kname]
            matched = [us for name, us in kernels if kname in name]
            on_device = len(matched)
            ms = sum(matched) * 1e-3
            log(f"trace {name}: {kname} {on_device} device kernels for {calls} calls, {ms:.3f} ms")
            assert on_device == calls, f"{kname}: {on_device} device kernels for {calls} calls"
        busy = sum(us for _, us in kernels) * 1e-6
        by_name: dict = {}
        for kname, us in kernels:
            by_name[kname] = by_name.get(kname, 0.0) + us * 1e-3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(
            f"trace {name}: first_call_s={first_wall:.4f} warm_wall_s={wall:.4f} traced_wall_s={traced:.4f} "
            f"device_busy_s={busy:.4f} idle_share={1.0 - busy / wall:.4f} "
            f"kernels={len(kernels)}"
        )
        for kname, ms in top:
            log(f"trace {name}:   {ms:9.3f} ms  {kname[:90]}")


def _reports_equal(a, b) -> bool:
    """Two report lists equal bitwise (estimates, trajectory, spectrum)."""
    return all(
        torch.equal(x.x_power, y.x_power) and torch.equal(x.x_trajectory, y.x_trajectory)
        and torch.equal(x.spectrum.j_total, y.spectrum.j_total) and x.total_error == y.total_error
        for x, y in zip(a, b)
    )


def phase_small_agreement() -> float:
    """The same profiling of a small fleet on the card and on the CPU:
    returns max |card - cpu| over report estimates, relative to their scale."""
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
    from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=300.0, seed=20), 3)
    sims = NodeSimulator(reg, SimulatorConfig(platform=PLATFORM)).simulate_fleet(traces)
    args = ([(t.fn_id, t.start, t.end) for t in traces], [s.telemetry for s in sims])
    worst = 0.0
    runs = {
        dev: fleet_profile_batched(FaasMeterProfiler(), *args, num_fns=len(reg), duration=300.0, device=dev)
        for dev in ("cuda", "cpu")
    }
    for rg, rc in zip(runs["cuda"], runs["cpu"]):
        assert abs(rg.skew_windows - rc.skew_windows) <= 1e-4, (rg.skew_windows, rc.skew_windows)
        for a, b in ((rg.x_power, rc.x_power), (rg.x_trajectory, rc.x_trajectory),
                     (rg.spectrum.j_total, rc.spectrum.j_total)):
            a, b = a.cpu().double(), b.double()
            worst = max(worst, float((a - b).abs().max()) / max(1.0, float(b.abs().max())))
    # The trace statistics are the host's bits on both devices, so only the
    # engine's float order differs: the north star's 1e-5 of scale.
    assert worst <= 1e-5, worst
    return worst


# ---------------------------------------------------------------------------
# Streaming control plane
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    """max |got - want| relative to the scale max(1, max |want|)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _windows(tels):
    """Each telemetry series of the fleet stacked (N, B) in numpy."""
    col = lambda get: np.stack([np.asarray(get(t)) for t in tels], axis=1).astype(np.float32)
    return (col(lambda t: t.system_power), col(lambda t: t.chip_power),
            col(lambda t: t.cp_cpu_frac), col(lambda t: t.sys_cpu_frac))


def phase_stream_engine(fleet, device="cuda") -> dict:
    """The streaming engine on the fleet phase's packed inputs: parity with
    ``run_fleet``, a tick-at-a-time ``fleet_step`` loop against
    ``run_fleet_stream`` (bitwise), and the per-tick cost against the
    segment engine's amortised one (the reference's ``streaming_overhead``
    metrics: each tick of the loop synchronised)."""
    from repro_torch.core.engine import (
        EngineConfig,
        fleet_initial_estimate,
        fleet_step,
        fleet_stream_init,
        fleet_ticks,
        run_fleet,
        run_fleet_stream,
    )

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    inputs, init_c, init_w = fleet["inputs"], fleet["init_c"], fleet["init_w"]
    b, s, n_w, m = inputs.c.shape
    t_total = s * n_w
    cfg = EngineConfig()
    out = {"engine_shape": [b, s, n_w, m], "ticks": t_total}
    seg = lambda: run_fleet(inputs, cfg, init_c=init_c, init_w=init_w, device=device)
    stream = run_fleet_stream(inputs, cfg, init_c=init_c, init_w=init_w, device=device)
    want = seg()
    out["stream_vs_segment_x_rel"] = max(
        _rel(stream.x0, want.x0), _rel(stream.x_final, want.x_final),
        _rel(stream.x_trajectory, want.x_trajectory),
    )
    out["stream_vs_segment_tick_power_rel"] = max(
        _rel(stream.tick_power, want.tick_power), _rel(stream.unattributed, want.unattributed)
    )
    ticks = fleet_ticks(inputs)
    tick_list = [ticks.at(t) for t in range(t_total)]

    def loop(lat=None):
        state = fleet_stream_init(fleet_initial_estimate(init_c, init_w, cfg), n_w, device=device)
        sync()
        xs = []
        for tk in tick_list:
            t1 = time.perf_counter()
            state, att = fleet_step(state, tk, cfg)
            if lat is not None:
                sync()
                lat.append(time.perf_counter() - t1)
            if att.step_completed:
                xs.append(att.x)
        sync()
        return state, xs

    state, xs = loop()
    out["tick_loop_bitwise"] = bool(
        torch.equal(torch.stack(xs, dim=1), stream.x_trajectory)
        and torch.equal(state.kalman.x, stream.x_final)
    )
    t0 = time.perf_counter()
    for _ in range(3):
        seg()
    sync()
    out["seg_us_per_tick"] = (time.perf_counter() - t0) / 3 / t_total * 1e6
    lat: list = []
    loop(lat)
    lat_us = np.asarray(lat) * 1e6
    out["stream_us_per_tick"] = float(lat_us.mean())
    out["stream_p50_us"] = float(np.percentile(lat_us, 50))
    out["stream_p99_us"] = float(np.percentile(lat_us, 99))
    out["stream_boundary_us_mean"] = float(lat_us[n_w - 1 :: n_w].mean())
    t0 = time.perf_counter()
    loop()
    out["stream_unsynced_us_per_tick"] = (time.perf_counter() - t0) / t_total * 1e6
    out["overhead_ratio"] = out["stream_us_per_tick"] / out["seg_us_per_tick"]
    _log_all("stream engine", out)
    assert out["stream_vs_segment_x_rel"] <= 1e-5, out
    assert out["stream_vs_segment_tick_power_rel"] <= 1e-4, out
    assert out["tick_loop_bitwise"], "tick-at-a-time fleet_step differs from run_fleet_stream"
    return out


def _log_all(prefix: str, out: dict) -> None:
    for k, v in out.items():
        log(f"{prefix} {k}: {v}")


def _open_stream(fleet, device, mode="pure", **kw):
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig

    tels = [sim.telemetry for sim in fleet["sims"]]
    return FaasMeterProfiler(ProfilerConfig(mode=mode)).start_fleet_stream(
        [(t.fn_id, t.start, t.end) for t in fleet["traces"]], num_fns=fleet["traces"][0].num_fns,
        duration=fleet["duration"], idle_watts=[t.idle_watts for t in tels],
        has_chip=True, has_cp=True, device=device, **kw,
    )


def _gated_stream(fleet, pointers=lambda sess: sess.buffer_pointers(), **kw):
    """Open a hookless session on the card and push the fleet's windows,
    from its first engine tick to its last under
    ``torch.cuda.set_sync_debug_mode("error")`` (any implicit
    synchronisation raises); ``pointers(sess)`` must not change over the
    stream.  Returns the session and the hookless dispatch rate."""
    windows = _windows([sim.telemetry for sim in fleet["sims"]])
    ptrs, armed = {}, []

    def arm(sess):
        ptrs.update(pointers(sess))
        torch.cuda.synchronize()
        armed.append(time.perf_counter())
        torch.cuda.set_sync_debug_mode("error")

    sess = _open_stream(fleet, "cuda", on_bootstrap=arm, **kw)
    try:
        for t in range(windows[0].shape[0]):
            sess.push_window(*(w[t] for w in windows))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - armed[0]
    t_total = sess.s * sess.cfg.step_windows
    assert sess.ticks_dispatched == t_total, (sess.ticks_dispatched, t_total)
    assert pointers(sess) == ptrs, "a carried buffer moved during the stream"
    return sess, t_total / wall


def phase_stream_gate(fleet) -> tuple[dict, list]:
    """A session with no ``on_tick`` hook, from its first engine tick to its
    last, under ``torch.cuda.set_sync_debug_mode("error")``: any implicit
    synchronisation of the dispatch stage raises.  Its carried buffers keep
    their storage.  The same session on the CPU (the one the CPU tests pin
    to the reference) gives the same skews and the same footprints and
    trajectory within 1e-5 of scale: the session computes the trace's
    statistics on the host, so card and CPU start from the same bits and
    part only by the engine's float order.  Returns the hookless dispatch
    rate and the card's reports."""
    windows = _windows([sim.telemetry for sim in fleet["sims"]])
    sess, rate = _gated_stream(fleet)
    reports = sess.finalize()
    cpu = _open_stream(fleet, "cpu")
    for t in range(windows[0].shape[0]):
        cpu.push_window(*(w[t] for w in windows))
    worst = 0.0
    for g, c in zip(reports, cpu.finalize()):
        assert g.skew_windows == c.skew_windows
        for f in ("x_power", "x_trajectory"):
            worst = max(worst, _rel(getattr(g, f), getattr(c, f)))
    out = {"gate_ticks": sess.ticks_dispatched, "gate_hookless_ticks_per_s": rate,
           "full_fleet_card_vs_cpu_rel": worst}
    _log_all("stream gate", out)
    assert worst <= 1e-5, worst
    return out, reports


def _tracker_state(tr):
    return (tr.j_indiv, tr.invocations, np.asarray([tr.elapsed_s, tr.steps_seen, tr.ticks_seen]))


def phase_control_plane(fleet, gate_reports, device="cuda") -> dict:
    """``EnergyFirstControlPlane.profile_fleet`` on the card over the fleet
    phase's traces (the same seeded telemetry): conservation on every tick
    (1e-3 W), efficiency of each report (1e-5 relative), ticks/s per ingest
    mode, and the three modes equal bitwise (reports and trackers) and
    equal to the hookless session's reports.  Against
    ``fleet_profile_batched`` each node's skew stays within 1 window and its
    Total-Error within the batched one + 0.05 (the reference's bounds for a
    synced fleet); the footprints' gap is recorded, not bounded by the
    reference test's 2 W: the session estimates skew on the init window
    only, and on this fleet the reference's own session is 7.03 W from its
    batched path at node 58 (tests/test_torch_control_plane.py)."""
    from repro_torch.serving import EnergyFirstControlPlane
    from repro_torch.workload.functions import paper_functions

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cp = EnergyFirstControlPlane(paper_functions(), device=device)
    t_first = N_INIT
    t_total = (int(fleet["duration"]) - N_INIT) // N_K * N_K
    out, runs = {}, {}
    for name, kw in (("prefetch0", dict(prefetch=0)), ("prefetch2", dict(prefetch=2)),
                     ("prefetch2_drain", dict(prefetch=2, drain=True))):
        seen, stamps, worst = [], [], [0.0]

        def on_tick(tk, trackers, seen=seen, stamps=stamps, worst=worst):
            stamps.append(time.perf_counter())
            seen.append(tk.t)
            recon = tk.tick_power.sum(-1) + tk.unattributed
            worst[0] = max(worst[0], float(np.abs(recon - tk.target).max()))

        t0 = time.perf_counter()
        res = cp.profile_fleet(fleet["traces"], on_tick=on_tick, **kw)
        sync()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        out[f"{name}_ticks_per_s"] = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        out[f"{name}_conservation_max_w"] = worst[0]
        log(f"control plane {name}: wall_s={out[f'{name}_wall_s']:.3f} "
            f"ticks_per_s={out[f'{name}_ticks_per_s']:.1f} conservation_max_w={worst[0]:.3e}")
        assert seen == list(range(t_first, t_first + t_total)), (name, seen[:3], len(seen))
        assert worst[0] <= 1e-3, (name, worst[0])
        runs[name] = res
    res = runs["prefetch2"]
    skew_d, x_d, terr_d, eff = [], [], [], []
    for pw, rb in zip(res, fleet["reports"]):
        rep = pw.report
        assert rep.x_power.device.type == device
        skew_d.append(abs(rep.skew_windows - rb.skew_windows))
        x_d.append(float((rep.x_power - rb.x_power).abs().max()))
        terr_d.append(rep.total_error - rb.total_error)
        total = float(rep.spectrum.j_indiv.sum()) + rep.cp_energy + rep.idle_energy
        eff.append(abs(float(rep.spectrum.j_total.sum()) - total) / total)
        assert pw.footprint_stream.ticks_seen == t_total
    out.update(vs_batched_skew_max=max(skew_d), vs_batched_x_power_max_w=max(x_d),
               vs_batched_x_power_argmax=int(np.argmax(x_d)),
               vs_batched_nodes_over_2w=int(sum(d > 2.0 for d in x_d)),
               vs_batched_total_error_max_excess=max(terr_d), efficiency_max_rel_err=max(eff))
    _log_all("control plane", out)
    assert max(skew_d) < 1.0 and max(terr_d) <= 0.05, out
    assert max(eff) <= 1e-5, out
    for name in ("prefetch0", "prefetch2_drain"):
        for a, b in zip(res, runs[name]):
            for f in ("x_power", "x_trajectory", "x_cp"):
                assert torch.equal(getattr(a.report, f), getattr(b.report, f)), (name, f)
            assert torch.equal(a.report.spectrum.j_total, b.report.spectrum.j_total), name
            assert a.report.total_error == b.report.total_error, name
            for u, v in zip(_tracker_state(a.footprint_stream), _tracker_state(b.footprint_stream)):
                assert np.array_equal(u, v), (name, "tracker")
    for a, g in zip(res, gate_reports):
        assert torch.equal(a.report.x_trajectory, g.x_trajectory), "profile_fleet vs hookless session"
    out["modes_bitwise_equal"] = True
    return out


def phase_stream_small_agreement() -> float:
    """``profile_fleet`` of a 3-node x 300 s fleet on the card and on the
    CPU: max |card - cpu| over reports and trackers, relative to scale."""
    from repro_torch.serving import EnergyFirstControlPlane
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=300.0, seed=20), 3)
    card = EnergyFirstControlPlane(reg).profile_fleet(traces)
    cpu = EnergyFirstControlPlane(reg, device="cpu").profile_fleet(traces)
    worst = 0.0
    for g, c in zip(card, cpu):
        assert abs(g.report.skew_windows - c.report.skew_windows) <= 1e-5
        for f in ("x_power", "x_trajectory"):
            worst = max(worst, _rel(getattr(g.report, f), getattr(c.report, f)))
        worst = max(worst, _rel(g.report.spectrum.j_total, c.report.spectrum.j_total))
        worst = max(worst, _rel(torch.from_numpy(g.footprint_stream.per_invocation_total),
                                torch.from_numpy(c.footprint_stream.per_invocation_total)))
    return worst


def phase_stream_trace(fleet, device="cuda") -> dict:
    """A hookless session on the card, past its first Kalman step: 120
    ticks (two steps) timed untraced, the next 120 under torch.profiler
    (device busy, idle share against the untraced wall, device operations,
    top kernels), then 59 mid-step ticks traced alone: device operations
    per mid-step tick, and per boundary tick from the difference."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    windows = _windows([sim.telemetry for sim in fleet["sims"]])
    sess = _open_stream(fleet, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pushed = [0]

    def run_to(tick):
        while sess._next_tick < tick:
            sess.push_window(*(w[pushed[0]] for w in windows))
            pushed[0] += 1
        sync()

    def traced(tick):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_to(tick)
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
        return ev, kern

    base = sess.init_n + N_K
    run_to(base)
    t0 = time.perf_counter()
    run_to(base + 2 * N_K)
    wall = time.perf_counter() - t0
    ev, kern = traced(base + 4 * N_K)
    out = {"trace_ticks": 2 * N_K, "trace_untraced_wall_s": wall}
    if device != "cuda":
        return out  # a CPU rehearsal has no device to trace
    assert ev, "torch.profiler recorded no device events: device busy and idle share not measured"
    busy = sum(e.time_range.elapsed_us() for e in ev) * 1e-6
    mid_ev, mid_kern = traced(base + 5 * N_K - 1)
    k_mid = len(mid_kern) / (N_K - 1)
    ops_mid = len(mid_ev) / (N_K - 1)
    out.update(
        trace_device_busy_s=busy, trace_idle_share=1.0 - busy / wall,
        trace_device_ops=len(ev), trace_kernels=len(kern),
        kernels_per_mid_tick=k_mid, device_ops_per_mid_tick=ops_mid,
        kernels_per_boundary_tick=(len(kern) - (2 * N_K - 2) * k_mid) / 2,
        device_ops_per_boundary_tick=(len(ev) - (2 * N_K - 2) * ops_mid) / 2,
        mid_tick_device_us=sum(e.time_range.elapsed_us() for e in mid_ev) / (N_K - 1),
    )
    _log_all("stream trace", out)
    by_name: dict = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"stream trace:   {ms:9.3f} ms  {kname[:90]}")
    return out


# ---------------------------------------------------------------------------
# Combined metering (§4.3) and the closed control loop
# ---------------------------------------------------------------------------


def _counter_specs(reg) -> dict:
    """The registry's (M,) step-counter specs, as the control plane derives
    them (``combined_counter_inputs``)."""
    return dict(
        gflops=np.asarray([s.gflops for s in reg.specs]),
        hbm_gb=np.asarray([s.hbm_gb for s in reg.specs]),
        mean_latency=np.asarray([max(s.mean_latency_s, 1e-3) for s in reg.specs]),
    )


def _efficiency(reports) -> float:
    """Max over nodes of |sum j_total - (sum j_indiv + cp + idle)| / total."""
    worst = 0.0
    for rep in reports:
        total = float(rep.spectrum.j_indiv.sum()) + rep.cp_energy + rep.idle_energy
        worst = max(worst, abs(float(rep.spectrum.j_total.sum()) - total) / total)
    return worst


def _combined_engine_inputs(fleet, device):
    """The fleet phase's packed engine inputs with the combined target:
    ``combined_rest_target(W_sys, W_chip, rest_idle)``, rest idle from the
    chip floor over the N_INIT block (the session's estimator)."""
    from repro_torch.core.engine import combined_rest_target, fleet_rest_idle

    n = int(fleet["duration"])
    tels = [sim.telemetry.to(device) for sim in fleet["sims"]]
    w = torch.stack([t.system_power[:n] for t in tels])
    chip = torch.stack([t.chip_power[:n] for t in tels])
    idle = torch.tensor([t.idle_watts for t in tels], dtype=torch.float32, device=device)
    target = combined_rest_target(w, chip, fleet_rest_idle(chip[:, :N_INIT], idle)[:, None])
    inputs = fleet["inputs"]
    b, s, n_w, _ = inputs.c.shape
    return inputs._replace(w=target[:, N_INIT : N_INIT + s * n_w].reshape(b, s, n_w)), target[:, :N_INIT]


def phase_combined_batched(fleet, device="cuda") -> tuple[dict, list]:
    """Combined mode on the fleet phase's 64 server nodes x 1,800 s:
    ``prepare_combined_fleet`` and ``fleet_profile_batched(mode="combined")``
    twice on the card (the same bits) and once on the CPU (1e-5 of scale),
    each report's efficiency (1e-5 relative).  Returns the metrics and the
    card's reports."""
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched, prepare_combined_fleet
    from repro_torch.workload.functions import paper_functions

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    reg = paper_functions()
    arrays = [(t.fn_id, t.start, t.end) for t in fleet["traces"]]
    tels = [sim.telemetry for sim in fleet["sims"]]
    prof = FaasMeterProfiler(ProfilerConfig(mode="combined"))
    kw = dict(num_fns=len(reg), duration=fleet["duration"])
    out = {}

    def prepare(dev):
        return prepare_combined_fleet(prof.config, arrays, tels, device=dev, **kw, **_counter_specs(reg))

    def profile(dev, inputs):
        return fleet_profile_batched(prof, arrays, tels, fn_counters=inputs[0], counter_model=inputs[2],
                                     device=dev, **kw)

    t0 = time.perf_counter()
    inputs = prepare(device)
    sync()
    out["prepare_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports = profile(device, inputs)
    sync()
    out["profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = profile(device, prepare(device))
    sync()
    out["prepare_and_profile_warm_s"] = time.perf_counter() - t0
    out["repeat_bitwise"] = _reports_equal(reports, again)
    out["efficiency_max_rel_err"] = _efficiency(reports)
    cpu = profile("cpu", prepare("cpu"))
    out["card_vs_cpu_rel"] = max(
        max(_rel(g.x_power, c.x_power), _rel(g.x_trajectory, c.x_trajectory),
            _rel(g.spectrum.j_total, c.spectrum.j_total))
        for g, c in zip(reports, cpu)
    )
    for rep in reports:
        assert torch.isfinite(rep.x_power).all() and rep.x_power.shape == (len(reg),)
        assert torch.isfinite(rep.x_trajectory).all()
    _log_all("combined batched", out)
    assert out["repeat_bitwise"], "two combined fleet_profile_batched calls on the card differ"
    assert out["card_vs_cpu_rel"] <= 1e-5, out
    assert out["efficiency_max_rel_err"] <= 1e-5, out
    return out, reports


def phase_combined_engine(fleet, device="cuda") -> dict:
    """The fleet's combined target through ``run_fleet_gram`` (the gram
    kernel) and ``run_fleet``: every tick's attribution plus the
    unattributed part is the target (1e-5 of scale, the energy of every
    window conserved), and the two engines agree at the pure phase's 5e-5
    of scale."""
    from repro_torch.core.engine import EngineConfig, run_fleet, run_fleet_gram

    comb, init_w = _combined_engine_inputs(fleet, device)
    cfg = EngineConfig()
    gram_res = run_fleet_gram(comb, cfg, init_c=fleet["init_c"], init_w=init_w, device=device)
    raw_res = run_fleet(comb, cfg, init_c=fleet["init_c"], init_w=init_w, device=device)
    target = comb.w.reshape(comb.w.shape[0], -1)
    recon = gram_res.tick_power.sum(-1) + gram_res.unattributed
    out = {"tick_conservation_rel": float((recon - target).abs().max()) / max(1.0, float(target.abs().max())),
           "gram_vs_raw_rel": _rel(gram_res.x_final, raw_res.x_final)}
    _log_all("combined engine", out)
    assert torch.isfinite(gram_res.x_trajectory).all()
    assert out["tick_conservation_rel"] <= 1e-5, out
    assert out["gram_vs_raw_rel"] <= 5e-5, out
    return out


def phase_combined_stream(fleet, batched_reports, device="cuda") -> dict:
    """``profile_fleet(mode="combined")`` on the same fleet: ticks/s,
    conservation on every tick (1e-3 W), efficiency (1e-5), and against the
    combined ``fleet_profile_batched`` each node's skew within 1 window and
    Total-Error within the batched one + 0.05 (PR 15's bounds); the
    footprints' gap is recorded."""
    from repro_torch.serving import EnergyFirstControlPlane
    from repro_torch.workload.functions import paper_functions

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cp = EnergyFirstControlPlane(paper_functions(), device=device)
    seen, stamps, worst = [], [], [0.0]

    def on_tick(tk, trackers):
        stamps.append(time.perf_counter())
        seen.append(tk.t)
        worst[0] = max(worst[0], float(np.abs(tk.tick_power.sum(-1) + tk.unattributed - tk.target).max()))

    t0 = time.perf_counter()
    res = cp.profile_fleet(fleet["traces"], mode="combined", on_tick=on_tick)
    sync()
    t_total = (int(fleet["duration"]) - N_INIT) // N_K * N_K
    out = {
        "wall_s": time.perf_counter() - t0,
        "ticks_per_s": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
        "conservation_max_w": worst[0],
        "efficiency_max_rel_err": _efficiency([p.report for p in res]),
        "vs_batched_skew_max": max(abs(p.report.skew_windows - b.skew_windows) for p, b in zip(res, batched_reports)),
        "vs_batched_total_error_max_excess": max(p.report.total_error - b.total_error
                                                 for p, b in zip(res, batched_reports)),
        "vs_batched_x_power_max_w": max(float((p.report.x_power - b.x_power).abs().max())
                                        for p, b in zip(res, batched_reports)),
    }
    _log_all("combined stream", out)
    assert seen == list(range(N_INIT, N_INIT + t_total)), (seen[:3], len(seen))
    assert all(p.footprint_stream.ticks_seen == t_total for p in res)
    assert out["conservation_max_w"] <= 1e-3, out
    assert out["efficiency_max_rel_err"] <= 1e-5, out
    assert out["vs_batched_skew_max"] < 1.0 and out["vs_batched_total_error_max_excess"] <= 0.05, out
    return out


def phase_combined_gate(fleet) -> dict:
    """A hookless combined session with retrain checks (window features),
    from its first engine tick to its last under
    ``torch.cuda.set_sync_debug_mode("error")``: the per-tick target and the
    boundary retrain checks wait on nothing.  The engine buffers, the
    counter models and ``x_cpu`` keep their storage."""
    from repro_torch.core.profiler import ProfilerConfig, prepare_combined_fleet
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    fnc, wf, models = prepare_combined_fleet(
        ProfilerConfig(mode="combined"), [(t.fn_id, t.start, t.end) for t in fleet["traces"]],
        [sim.telemetry for sim in fleet["sims"]], num_fns=len(reg), duration=fleet["duration"],
        **_counter_specs(reg),
    )

    def pointers(sess):
        return dict(sess.buffer_pointers(), model_w=sess._models.weights.data_ptr(),
                    model_b=sess._models.bias.data_ptr(), x_cpu=sess.x_cpu.data_ptr())

    sess, rate = _gated_stream(fleet, pointers, mode="combined", fn_counters=fnc, counter_model=models,
                               window_features=wf)
    out = {"gate_ticks": sess.ticks_dispatched, "gate_hookless_ticks_per_s": rate,
           "gate_retrain_checks": len(sess.model_errors), "gate_buffers": len(pointers(sess))}
    assert len(sess.model_errors) == sess.s, out
    assert len(sess.finalize()) == len(fleet["traces"])
    _log_all("combined gate", out)
    return out


def phase_combined_mixed(device="cuda", duration=300.0) -> dict:
    """A server/desktop/edge fleet in one combined batch (the edge node has
    no chip sensor): through ``fleet_profile_batched`` and
    ``profile_fleet``, its chipless row equals the pure path's run of that
    node alone (1e-5 of scale), and every row is finite."""
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched, prepare_combined_fleet
    from repro_torch.serving import EnergyFirstControlPlane
    from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    platforms = ["server", "desktop", "edge"]
    traces = fleet_traces(reg, WorkloadConfig(duration_s=duration, seed=30), 3)
    sims = NodeSimulator(reg, SimulatorConfig()).simulate_fleet(traces, platforms=platforms)
    arrays = [(t.fn_id, t.start, t.end) for t in traces]
    tels = [s.telemetry for s in sims]
    assert tels[2].chip_power is None and tels[0].chip_power is not None
    prof = FaasMeterProfiler(ProfilerConfig(mode="combined"))
    fnc, _, models = prepare_combined_fleet(prof.config, arrays, tels, num_fns=len(reg), duration=duration,
                                            device=device, **_counter_specs(reg))
    mixed = fleet_profile_batched(prof, arrays, tels, num_fns=len(reg), duration=duration,
                                  fn_counters=fnc, counter_model=models, device=device)
    pure = fleet_profile_batched(FaasMeterProfiler(), arrays[2:], tels[2:], num_fns=len(reg),
                                 duration=duration, device=device)[0]
    cp = EnergyFirstControlPlane(reg, device=device)
    live = cp.profile_fleet(traces, seeds=[40, 41, 42], platforms=platforms, mode="combined")
    live_pure = cp.profile_fleet(traces[2:], seeds=[42], platforms=platforms[2:])[0]
    out = {
        "mixed_batched_chipless_vs_pure_rel": max(_rel(mixed[2].x_power, pure.x_power),
                                                  _rel(mixed[2].x_trajectory, pure.x_trajectory)),
        "mixed_stream_chipless_vs_pure_rel": max(_rel(live[2].report.x_power, live_pure.report.x_power),
                                                 _rel(live[2].report.x_trajectory, live_pure.report.x_trajectory)),
        "mixed_efficiency_max_rel_err": _efficiency(mixed + [p.report for p in live]),
    }
    for rep in mixed + [p.report for p in live]:
        assert torch.isfinite(rep.x_power).all()
    _log_all("combined mixed", out)
    assert out["mixed_batched_chipless_vs_pure_rel"] <= 1e-5, out
    assert out["mixed_stream_chipless_vs_pure_rel"] <= 1e-5, out
    assert out["mixed_efficiency_max_rel_err"] <= 1e-5, out
    return out


def phase_combined_controller(device="cuda", shape=COMBINED_SHAPE, reps=3) -> dict:
    """The reference's ``benchmarks/combined_fleet.py`` at the fleet-
    controller shape, on the port: ``pure_ms`` (run_fleet on the
    idle-adjusted target), ``combined_ms`` (fit + target + run_fleet +
    chip split), ``overhead_ratio`` (recorded; the reference accepts about
    1.2), ``fit_ms``, ``chip_split_ms`` and ``conservation_err`` (max per
    tick |attributed + unattributed - target|, at most 1e-3 W as the
    reference's test holds it).  Then the combined target through
    ``run_fleet_gram`` — the gram kernel at M = 128 — against ``run_fleet``
    (5e-5 of scale).  Times are warm, device-synchronised means of
    ``reps``."""
    from repro_torch.core import cpu_model as cpumod
    from repro_torch.core.engine import (
        EngineConfig,
        combined_rest_target,
        fleet_rest_idle,
        run_fleet,
        run_fleet_gram,
        synthetic_fleet,
    )
    from repro_torch.telemetry.counters import function_counters, window_counters

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    b, s, n_w, m = shape
    n = s * n_w
    cfg = EngineConfig()
    inputs = synthetic_fleet(b, s, n_w, m, seed=0, device=device)
    rng = np.random.default_rng(1)
    gflops = torch.as_tensor(np.abs(rng.standard_normal(m)) * 40.0 + 1.0, dtype=torch.float32, device=device)
    hbm_gb = gflops / 30.0
    lat = torch.as_tensor(np.abs(rng.standard_normal(m)) * 0.8 + 0.2, dtype=torch.float32, device=device)
    c_windows = inputs.c.reshape(b, n, m)
    wf = window_counters(c_windows, gflops, hbm_gb, lat, cfg.delta)
    chip = wf @ torch.tensor([0.002, 0.1, 30.0], device=device) + 40.0 + torch.as_tensor(
        0.5 * rng.standard_normal((b, n)), dtype=torch.float32, device=device)
    idle = torch.full((b,), 90.0, device=device)
    w_sys = inputs.w.reshape(b, n) + chip + 48.0
    fn_c = function_counters(c_windows, gflops, hbm_gb, lat)
    busy = c_windows.sum(dim=1)
    duration = torch.full((b,), float(n), device=device)
    init_n = min(60, n)

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3, res

    def split(models):
        return cpumod.predict_function_power_split(models, fn_c, busy / duration[:, None])

    def target():
        return combined_rest_target(w_sys, chip, fleet_rest_idle(chip[:, :init_n], idle)[:, None])

    def combined():
        models = cpumod.fit_ridge(wf[:, :init_n], chip[:, :init_n])
        res = run_fleet(inputs._replace(w=target().reshape(b, s, n_w)), cfg, device=device)
        return res, split(models)

    out = {"fleet_shape": f"B{b} S{s} n_w{n_w} M{m}"}
    out["pure_ms"], _ = timed(lambda: run_fleet(inputs, cfg, device=device))
    out["combined_ms"], (res, _) = timed(combined)
    out["overhead_ratio"] = out["combined_ms"] / out["pure_ms"]
    out["fit_ms"], models = timed(lambda: cpumod.fit_ridge(wf[:, :init_n], chip[:, :init_n]))
    out["chip_split_ms"], _ = timed(lambda: split(models))
    tgt = target()
    out["conservation_err"] = float((res.tick_power.sum(-1) + res.unattributed - tgt).abs().max())
    comb = inputs._replace(w=tgt.reshape(b, s, n_w))
    out["combined_gram_ms"], gram_res = timed(lambda: run_fleet_gram(comb, cfg, device=device))
    out["gram_calls"] = reps + 1  # two gram launches each: X_0 and the step hoist
    out["gram_vs_raw_rel"] = _rel(gram_res.x_final, res.x_final)
    _log_all("combined controller", out)
    assert torch.isfinite(res.x_trajectory).all() and torch.isfinite(gram_res.x_trajectory).all()
    assert out["conservation_err"] <= 1e-3, out
    assert out["gram_vs_raw_rel"] <= 5e-5, out
    return out


def _control_replay(device, *, duration, load, nodes, seed, quantile=0.90, drift=None, hook_times=None):
    """One closed-loop replay (the reference's ``benchmarks/control_loop.py``
    ``_replay``): the cap at ``quantile`` of the uncontrolled system power,
    ``profile_fleet(mode="combined", control=ControlLoop(...))``, then the
    controlled traces re-simulated.  ``hook_times`` collects the control
    hook's seconds per tick."""
    from repro_torch.core.profiler import ProfilerConfig
    from repro_torch.serving import ControlConfig, ControlLoop, EnergyFirstControlPlane
    from repro_torch.telemetry.simulator import SimulatorConfig, chip_drift_transform
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=duration, load=load, seed=seed), nodes)
    cp = EnergyFirstControlPlane(reg, SimulatorConfig(platform="server", seed=0),
                                 ProfilerConfig(init_windows=60, step_windows=30), device=device)
    w = np.stack([np.asarray(s.telemetry.system_power) for s in cp.simulator.simulate_fleet(traces, None)])
    cap = float(np.quantile(w, quantile))
    loop = ControlLoop(ControlConfig(cap_watts=cap))
    if hook_times is not None:
        hook = loop.on_tick

        def timed_hook(tk, trackers):
            t0 = time.perf_counter()
            hook(tk, trackers)
            hook_times.append(time.perf_counter() - t0)

        loop.on_tick = timed_hook
    t0 = time.perf_counter()
    cp.profile_fleet(traces, mode="combined", control=loop,
                     tick_transform=chip_drift_transform(*drift) if drift else None)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ct = loop.controlled_traces()
    wc = np.stack([np.asarray(s.telemetry.system_power) for s in cp.simulator.simulate_fleet(ct, None)])
    return dict(cp=cp, traces=traces, w=w, cap=cap, loop=loop, wall=wall, ct=ct, wc=wc)


def _schedule(ct):
    """Each node's controlled invocations as a set of (fn, start, end)."""
    return [set(zip(t.fn_id.tolist(), t.start.tolist(), t.end.tolist())) for t in ct]


def _differing(a, b, t_split: float) -> tuple[int, int, float]:
    """The invocations schedule ``a`` places where ``b`` does not (another
    node or start): those ``a`` starts before ``t_split`` (the live,
    admitted region) and from it on (the end-of-segment packing), and the
    earliest start at which the two part (None when equal)."""
    live = drain = 0
    first = float("inf")
    for x, y in zip(_schedule(a), _schedule(b)):
        only = x - y
        live += sum(1 for e in only if e[1] < t_split)
        drain += sum(1 for e in only if e[1] >= t_split)
        first = min([first] + [e[1] for e in x ^ y])
    return live, drain, None if first == float("inf") else first


def phase_control(device="cuda", main=None, retrain=None) -> dict:
    """The closed control loop on the card.

    Main run (``benchmarks/control_loop.py:71``'s acceptance shape: 4 nodes
    x 420 s, load 45, seed 7, >= 1e5 invocations, cap at the 0.90 quantile
    of the uncontrolled power): controlled overshoot below uncontrolled;
    work conserved (per-function counts equal, busy seconds to rtol 1e-5);
    starts only move forward; a second card replay equal bitwise
    (placements, re-simulated power, summary and bill).  Recorded: the
    replay's wall time, the control hook's cost per tick, queue waits,
    makespan stretch, and how many admission decisions differ from the same
    loop on the CPU.  Retrain run (``:84-86``: 2 nodes x 300 s, load 4,
    seed 11, the chip sensor drifting x1.4 from window 120): retraining
    fires after the drift and the model error falls back under the 0.05
    threshold.  Then ``run_capped`` on one node: overshoot below the
    uncapped run's."""
    main = main or dict(duration=420.0, load=45.0, nodes=4, seed=7)
    retrain = retrain or dict(duration=300.0, load=4.0, nodes=2, seed=11, drift=(1.4, 120.0))
    hook_times: list = []
    run = _control_replay(device, hook_times=hook_times, **main)
    again = _control_replay(device, **main)
    cpu = _control_replay("cpu", **main)
    traces, ct, w, wc, cap, loop = run["traces"], run["ct"], run["w"], run["wc"], run["cap"], run["loop"]
    m = traces[0].num_fns

    def per_fn(trs, busy):
        out = np.zeros(m)
        for t in trs:
            ok = t.fn_id >= 0
            np.add.at(out, t.fn_id[ok], (t.end - t.start)[ok].astype(np.float64) if busy else 1.0)
        return out

    summ = loop.summary()
    hook_us = np.asarray(hook_times) * 1e6
    sched, sched_cpu = _schedule(ct), _schedule(cpu["ct"])
    out = {
        "fleet_shape": f"B{main['nodes']} x {main['duration']:.0f}s @ load {main['load']:g}",
        "invocations": int(sum(int((t.fn_id >= 0).sum()) for t in traces)),
        "cap_watts": cap,
        "overshoot_uncontrolled": float(np.mean(w > cap)),
        "overshoot_controlled": float(np.mean(wc > cap)),
        "deferred_by_cap": summ["deferred_by_cap"],
        "mean_queue_wait_s": summ["mean_queue_wait_s"],
        "max_queue_wait_s": summ["max_queue_wait_s"],
        "makespan_stretch": float(ct[0].duration) / main["duration"],
        "control_wall_s": run["wall"],
        "control_wall_cpu_s": cpu["wall"],
        "hook_ticks": len(hook_times),
        "hook_us_per_tick_mean": float(hook_us.mean()),
        "hook_us_per_tick_p99": float(np.percentile(hook_us, 99)),
        "hook_share_of_wall": float(np.sum(hook_times)) / run["wall"],
        "replay_bitwise": bool(
            sched == _schedule(again["ct"]) and np.array_equal(wc, again["wc"])
            and summ == again["loop"].summary()
            and np.array_equal(loop.meter.j_total, again["loop"].meter.j_total)
        ),
        "decisions_differing_from_cpu": sum(len(a ^ b) for a, b in zip(sched, sched_cpu)) // 2,
        **dict(zip(("differing_live", "differing_drain", "first_differing_start_s"),
                   _differing(ct, cpu["ct"], loop.n_used * loop.delta))),
        "overshoot_controlled_cpu": float(np.mean(cpu["wc"] > cpu["cap"])),
        "billed_joules": summ["billed_joules"],
        "billed_joules_cpu": cpu["loop"].summary()["billed_joules"],
    }
    orig = np.sort(np.concatenate([(t.end - t.start)[t.fn_id >= 0] for t in traces]))
    ctrl = np.sort(np.concatenate([(t.end - t.start)[t.fn_id >= 0] for t in ct]))
    t_orig = np.concatenate([t.start[t.fn_id >= 0] for t in traces])
    t_ctrl = np.concatenate([t.start[t.fn_id >= 0] for t in ct])
    out["start_shift_total_s"] = float(t_ctrl.astype(np.float64).sum() - t_orig.astype(np.float64).sum())

    drift = _control_replay(device, **retrain)
    dloop = drift["loop"]
    errs = np.stack(dloop.session.model_errors)
    thr = dloop.session._retrain_cfg.retrain_threshold
    out.update(
        retrain_events=len(dloop.retrain_events),
        retrain_first_tick=int(dloop.retrain_events[0][0]) if dloop.retrain_events else -1,
        retrain_err_pre=float(errs[0].max()), retrain_err_peak=float(errs.max()),
        retrain_err_post=float(errs[-1].max()),
    )

    from repro_torch.serving import EnergyFirstControlPlane
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    trace = fleet_traces(reg, WorkloadConfig(duration_s=300.0, load=3.0, seed=2), 1)[0]
    cp = EnergyFirstControlPlane(reg, device=device)
    free = cp.run_capped(trace, float("inf"))
    cap1 = float(np.quantile(free.power_series, 0.8))
    capped = cp.run_capped(trace, cap1)
    out.update(capped_overshoot_uncapped=float(np.mean(free.power_series > cap1)),
               capped_overshoot=capped.overshoot_fraction,
               capped_mean_queue_wait_s=float(capped.queue_waits.mean()))
    _log_all("control", out)
    assert out["invocations"] >= (100_000 if main["load"] >= 45 else 1), out
    assert out["overshoot_controlled"] < out["overshoot_uncontrolled"], out
    np.testing.assert_array_equal(per_fn(traces, False), per_fn(ct, False))
    np.testing.assert_allclose(per_fn(traces, True), per_fn(ct, True), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(orig, ctrl, rtol=1e-5, atol=2e-3)
    assert out["start_shift_total_s"] >= -1e-3, out
    assert out["replay_bitwise"], "two controlled replays on the card differ"
    assert dloop.retrain_events and out["retrain_first_tick"] >= retrain["drift"][1], out
    assert out["retrain_err_pre"] < thr < out["retrain_err_peak"] and out["retrain_err_post"] < thr, out
    assert out["capped_overshoot"] < out["capped_overshoot_uncapped"], out
    return out


# ---------------------------------------------------------------------------
# Elastic serving: length buckets, the node-axis mesh, the slot pool
# ---------------------------------------------------------------------------


def _record_gram():
    """Wrap the gram backend the engine resolves (``core.engine.plan.
    _gram_fn``) so every (G, N, M) it assembles is kept with its first
    inputs, for the parity phase; the kernel's own wrapper still counts
    the launch.  Returns (seen, restore)."""
    from repro_torch.core.engine import plan

    seen: dict = {}
    resolve = plan._gram_fn

    def recording_resolve(backend, device):
        gram_fn = resolve(backend, device)
        if gram_fn is None:
            return None

        def recording(c, w):
            n, m = c.shape[-2:]
            g = c.numel() // (n * m)
            seen.setdefault((g, n, m), (c.detach().reshape(g, n, m).clone(), w.detach().reshape(g, n).clone()))
            return gram_fn(c, w)

        return recording

    plan._gram_fn = recording_resolve

    def restore():
        plan._gram_fn = resolve

    return seen, restore


def _window_arrays(inputs):
    """Per-window arrays of a packed (B, S, n_w, M) batch: each step's
    invocation and latency sums on its first window (packing sums them
    back), so a ragged pack of these gives the packed data."""
    b, s, n_w, m = inputs.c.shape

    def first(x):
        out = x.new_zeros((b, s, n_w, m))
        out[:, :, 0] = x
        return out.reshape(b, s * n_w, m)

    return (inputs.c.reshape(b, -1, m), inputs.w.reshape(b, -1),
            first(inputs.a), first(inputs.lat_sum), first(inputs.lat_sumsq))


def _bucketed_run(label, wins, lengths, n_w, buckets, launches, device) -> dict:
    """A ragged fleet packed once whole and once in length buckets:
    ``run_fleet_bucketed`` with ``run_fleet`` and with ``run_fleet_gram``
    (the gram kernel once for X_0 and once for the step hoist, per bucket)
    against the same engine on the monolithic pack, 1e-5 of scale; the two
    engines' own gap on the monolithic pack (the main path's bound, 5e-5
    of scale); the padding each pack computes over; the gram's launches."""
    from repro_torch.core.engine import (
        EngineConfig, bucketed_pad_waste, pack_fleet_buckets, pack_fleet_inputs, pad_waste_frac,
        run_fleet, run_fleet_bucketed, run_fleet_gram,
    )

    cfg = EngineConfig()
    mono_in = pack_fleet_inputs(*wins, step_windows=n_w, lengths=lengths, device=device)
    bks = pack_fleet_buckets(*wins, step_windows=n_w, lengths=lengths, buckets=buckets, device=device)
    out = {"buckets": {bk.steps: len(bk.nodes) for bk in bks}, "pad_waste_frac": pad_waste_frac(lengths, n_w),
           "bucketed_pad_waste": bucketed_pad_waste(bks, n_w)}
    mono = {}
    for engine in (run_fleet, run_fleet_gram):
        name = engine.__name__
        t0 = time.perf_counter()
        mono[name] = engine(mono_in, cfg, with_ticks=False, device=device)
        _sync(device)
        out[f"{name}_monolithic_s"] = time.perf_counter() - t0
        before = launches()
        t0 = time.perf_counter()
        x, x0, _ = run_fleet_bucketed(bks, cfg, engine=engine)
        _sync(device)
        out[f"{name}_bucketed_s"] = time.perf_counter() - t0
        out[f"{name}_bucketed_disagg_gram_launches"] = launches() - before
        out[f"{name}_vs_monolithic_rel"] = max(_rel(x, mono[name].x_final), _rel(x0, mono[name].x0))
    out["gram_vs_raw_monolithic_rel"] = _rel(mono["run_fleet_gram"].x_final, mono["run_fleet"].x_final)
    _log_all(f"elastic buckets {label}", out)
    for name in ("run_fleet", "run_fleet_gram"):
        assert out[f"{name}_vs_monolithic_rel"] <= 1e-5, (label, out)
    assert out["gram_vs_raw_monolithic_rel"] <= 5e-5, (label, out)
    assert out["run_fleet_gram_bucketed_disagg_gram_launches"] == (2 * len(bks) if device == "cuda" else 0), out
    assert out["run_fleet_bucketed_disagg_gram_launches"] == 0, out
    return out


def phase_elastic_buckets(fleet, launches, device="cuda") -> dict:
    """Length buckets at full size: the fleet phase's 64 x 1,800 s fleet
    (M = 8) made ragged, in ``DEFAULT_BUCKETS`` (8, 16 and 32 steps of 60
    windows; the 32-step bucket's X_0 gram has N = 1,920, past the warp
    variant's N); and benchmarks/ragged_fleet.py's r50 fleet at M = 128 in
    buckets of 1-8 steps (the tiled variant)."""
    from repro_torch.core.engine import DEFAULT_BUCKETS, synthetic_ragged_windows

    wins = _window_arrays(fleet["inputs"])
    n = wins[1].shape[1]
    lengths = np.random.default_rng(0).integers(n // 4, n + 1, size=wins[1].shape[0])
    lengths[0] = n
    out = {"paper_fleet": _bucketed_run("paper_fleet", wins, lengths.tolist(), N_K, DEFAULT_BUCKETS, launches,
                                        device)}
    b, s, n_w, m = RAGGED_SHAPE
    n = s * n_w
    # benchmarks/ragged_fleet.py's _pack: one generator (seed 0) draws the
    # r75 fleet's lengths first, then r50's.
    rng = np.random.default_rng(0)
    for ratio in (0.75, 0.50):
        lengths = rng.integers(max(int(ratio * n), n_w), n + 1, size=b).tolist()
        lengths[0] = n
    wins = synthetic_ragged_windows(b, n, m, lengths=lengths, seed=1, device=device)
    out["ragged_r50_m128"] = _bucketed_run("ragged_r50_m128", wins, lengths, n_w, RAGGED_BUCKETS, launches, device)
    return out


def phase_elastic_mesh(fleet, launches, device="cuda") -> dict:
    """The node-axis mesh on one card.  A one-device mesh
    (``fleet_mesh(devices=["cuda:0"])``) through ``run_fleet_gram``,
    ``run_fleet_stream`` and a tick-at-a-time ``fleet_step`` stream gives
    the mesh=None result bit for bit; a two-entry mesh over the same card
    (its split, per-shard dispatch and join; it measures no scaling) gives
    it within 1e-5 of scale, with the gram kernel launched per shard;
    ``fleet_attribution_totals(mesh=)`` equals the plain sums (rtol 1e-5)
    with and without a mask and chip power; a slot pool resharded
    None -> two entries -> None mid-stream equals an uninterrupted one
    (1e-5 of scale); and ``fleet_mesh_auto(64)`` is None on one card."""
    from repro_torch.core.engine import (
        EngineConfig, FleetStep, fleet_initial_estimate, fleet_step, fleet_stream_init, fleet_ticks,
        run_fleet_gram, run_fleet_stream,
    )
    from repro_torch.core.sessions import SlotFleetSession
    from repro_torch.distributed import Shards, fleet_attribution_totals, fleet_mesh, fleet_mesh_auto

    cfg = EngineConfig()
    inputs, kw = fleet["inputs"], dict(init_c=fleet["init_c"], init_w=fleet["init_w"])
    b, s, n_w, m = inputs.c.shape
    dev0 = "cuda:0" if device == "cuda" else device
    one, two = fleet_mesh(devices=[dev0]), fleet_mesh(devices=[dev0] * 2)
    fields = ("x_final", "x_trajectory", "x0", "tick_power", "unattributed")
    out, plain = {}, {}
    for fn in (run_fleet_gram, run_fleet_stream):
        name = fn.__name__
        plain[name] = want = fn(inputs, cfg, device=device, **kw)
        before = launches()
        got = fn(inputs, cfg, mesh=one, **kw)
        out[f"{name}_one_device_gram_launches"] = launches() - before
        out[f"{name}_one_device_bitwise"] = all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields) \
            and all(torch.equal(x, y) for x, y in zip(got.state, want.state))
        before = launches()
        t0 = time.perf_counter()
        got = fn(inputs, cfg, mesh=two, **kw)
        _sync(device)
        out[f"{name}_two_entry_s"] = time.perf_counter() - t0
        out[f"{name}_two_entry_gram_launches"] = launches() - before
        out[f"{name}_two_entry_rel"] = max(_rel(getattr(got, f), getattr(want, f)) for f in fields)
    ticks = fleet_ticks(inputs)
    x0 = fleet_initial_estimate(kw["init_c"], kw["init_w"], cfg)

    def stream(mesh):
        state = fleet_stream_init(x0, n_w, mesh=mesh, device=device)
        xs = []
        for t in range(s * n_w):
            state, att = fleet_step(state, ticks.at(t), cfg, mesh=mesh)
            if att.step_completed:
                xs.append(att.x)
        return torch.stack(xs, dim=1), state

    traj, state = stream(None)
    traj1, state1 = stream(one)
    traj2, state2 = stream(two)
    out["fleet_step_one_device_bitwise"] = bool(torch.equal(traj1, traj) and torch.equal(state1[0].kalman.x, state.kalman.x))
    out["fleet_step_two_entry_rel"] = max(_rel(traj2, traj), _rel(two.join([st.kalman.x for st in state2]), state.kalman.x))
    res = plain["run_fleet_gram"]
    rng = np.random.default_rng(0)
    mask = torch.from_numpy((rng.random((b, s * n_w)) > 0.2).astype(np.float32)).to(device)
    chip = torch.from_numpy((rng.random((b, m)) * 30.0).astype(np.float32)).to(device)
    worst = 0.0
    for extra in ({}, {"mask": mask}, {"chip_power": chip}, {"mask": mask, "chip_power": chip}):
        args = (res.tick_power, res.unattributed, res.x_final[:, -1])
        got, want = fleet_attribution_totals(*args, mesh=two, **extra), fleet_attribution_totals(*args, **extra)
        for g, w in zip(got, want):
            worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    out["totals_two_entry_vs_plain_rel"] = worst

    def pool_run(reshards):
        pool = SlotFleetSession(b, m, step_windows=n_w, config=cfg, device=device)
        pool.warmup()
        for i in range(b):
            pool.admit(i, x0=x0[i])
        for t in range(horizon):
            if t in reshards:
                pool.reshard(reshards[t])
                assert isinstance(pool.state, Shards) == (reshards[t] is not None)
            tk = ticks.at(t)
            pool.advance(FleetStep(*tk[:5], valid=torch.ones(b, device=device)))
        return pool.engine_x()

    horizon = min(10 * n_w, s * n_w)
    out["reshard_mid_stream_rel"] = _rel(pool_run({horizon // 3: two, 2 * horizon // 3: None}), pool_run({}))
    out["fleet_mesh_auto_64"] = repr(fleet_mesh_auto(B_NODES))
    _log_all("elastic mesh", out)
    for name in ("run_fleet_gram", "run_fleet_stream"):
        assert out[f"{name}_one_device_bitwise"], (name, "one-device mesh differs from mesh=None")
        assert out[f"{name}_two_entry_rel"] <= 1e-5, out
    per_call = 2 if device == "cuda" else 0
    assert out["run_fleet_gram_one_device_gram_launches"] == per_call, out
    assert out["run_fleet_gram_two_entry_gram_launches"] == 2 * per_call, out
    assert out["run_fleet_stream_two_entry_gram_launches"] == 0, out
    assert out["fleet_step_one_device_bitwise"] and out["fleet_step_two_entry_rel"] <= 1e-5, out
    assert out["totals_two_entry_vs_plain_rel"] <= 1e-5 and out["reshard_mid_stream_rel"] <= 1e-5, out
    if torch.cuda.device_count() <= 1:
        assert fleet_mesh_auto(B_NODES) is None
    return out


def _slot_trace(device: str, gate: bool = False, w_ulp: bool = False) -> tuple[dict, dict, list]:
    """benchmarks/slot_serving.py's churn trace at its full size through a
    ``SlotFleetSession`` behind a ``SlotAdmissionQueue`` on ``device``: the
    same schedule (``churn_schedule`` seed 0), init blocks and feeds
    (seed 1, 5 % of windows dropped), each tick timed to the card's
    completion.  With ``gate`` every release, admission and step runs under
    ``torch.cuda.set_sync_debug_mode("error")``; with ``w_ulp`` every fed
    power is raised by one unit in the last place.  The stand-in for the
    reference's zero-retrace gate: the pool's buffers do not move from
    ``warmup()`` to the end, and no kernel source is built after it.
    Returns the metrics, the final estimates and the tenancy lengths."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.sessions import SlotFleetSession
    from repro_torch.kernels import build
    from repro_torch.serving.scheduler import SlotAdmissionQueue
    from repro_torch.telemetry.simulator import churn_schedule

    cap, m, n_w, horizon, population = SLOT_POOL
    spans = churn_schedule(population, horizon, capacity=cap, seed=0,
                           mean_lifetime=horizon / 6.0, mean_gap=horizon / (2.5 * population))
    joins: dict = {}
    leaves: dict = {}
    for sp in spans:
        joins.setdefault(sp.join, []).append(sp.node)
        leaves.setdefault(sp.leave, []).append(sp.node)
    pool = SlotFleetSession(cap, m, step_windows=n_w, config=EngineConfig(), device=device)
    ptrs = pool.warmup()
    built = len(build.built)
    queue = SlotAdmissionQueue(pool)
    rng = np.random.default_rng(1)
    init_blocks = {
        sp.node: (rng.random((int(rng.integers(4, 3 * n_w)), m)).astype(np.float32),
                  (rng.random(int(rng.integers(4, 3 * n_w))) * 30.0).astype(np.float32))
        for sp in spans
    }
    # (init_c, init_w) lengths must agree per node (the benchmark's rule).
    init_blocks = {node: (c[: len(w)], w[: len(c)]) for node, (c, w) in init_blocks.items()}
    lat = []
    t_start = time.perf_counter()
    for t in range(horizon):
        t0 = time.perf_counter()
        if gate:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for node in leaves.get(t, ()):
                if node in pool.live_nodes:
                    pool.release(node)
            queue.drain()
            for node in joins.get(t, ()):
                queue.submit(node, *init_blocks[node])
            feeds = {}
            for node in pool.live_nodes:
                if rng.random() < 0.05:
                    continue  # dropped window
                feeds[node] = (
                    rng.random(m).astype(np.float32), np.float32(40.0 + 10.0 * rng.random()),
                    rng.integers(0, 2, m).astype(np.float32), rng.random(m).astype(np.float32),
                    rng.random(m).astype(np.float32),
                )
                if w_ulp:
                    feeds[node] = (feeds[node][0], np.nextafter(feeds[node][1], np.float32(np.inf)),
                                   *feeds[node][2:])
            pool.step(feeds)
        finally:
            if gate:
                torch.cuda.set_sync_debug_mode(0)
        _sync(device)
        lat.append(time.perf_counter() - t0)
    total_s = time.perf_counter() - t_start
    assert pool.buffer_pointers() == ptrs, "a pool buffer moved during the churn trace"
    assert len(build.built) == built, f"kernel sources built after warmup: {build.built[built:]}"
    lat_us = np.asarray(lat) * 1e6
    out = {
        "pool": f"cap{cap} M{m} n_w{n_w}", "horizon_ticks": horizon, "population": len(spans),
        "admits": pool.admits, "releases": pool.releases, "queue_deferred": queue.deferred,
        "ticks_per_sec": horizon / total_s, "tick_us_mean": float(lat_us.mean()),
        "tick_p99_us": float(np.percentile(lat_us, 99)),
        "buffers_unmoved": True, "builds_after_warmup": len(build.built) - built,
    }
    lengths = [max(sp.leave - sp.join, 1) for sp in spans]
    return out, pool.estimates(), lengths


def phase_slot_pool(device="cuda") -> dict:
    """The slot pool at benchmarks/slot_serving.py's full size on the card
    under the sync gate, then the same trace on the CPU: the live nodes'
    final estimates agree within 1e-5 of scale, or, where the trace itself
    is worse conditioned than that, within four times the CPU's own move
    when every fed power changes by one unit in the last place (measured in
    the same call: the feeds are random, the 60-tick grams at M = 64 are
    rank-deficient, and each boundary's NNLS amplifies last-bit
    differences).  Also the padding the trace's tenancy lengths waste in
    one pack against length buckets."""
    from repro_torch.core.engine import (
        bucketed_pad_waste, pack_fleet_buckets, pad_waste_frac, synthetic_ragged_windows,
    )

    out, card, lengths = _slot_trace(device, gate=device == "cuda")
    cpu_out, cpu, _ = _slot_trace("cpu")
    _, cpu_ulp, _ = _slot_trace("cpu", w_ulp=True)
    assert set(card) == set(cpu) == set(cpu_ulp) and cpu_out["admits"] == out["admits"], (out, cpu_out)
    nodes = sorted(card)
    est = lambda e: torch.from_numpy(np.stack([e[n] for n in nodes]))  # noqa: E731
    out["card_vs_cpu_rel"] = _rel(est(card), est(cpu))
    out["cpu_one_ulp_w_rel"] = _rel(est(cpu_ulp), est(cpu))
    out["cpu_ticks_per_sec"] = cpu_out["ticks_per_sec"]
    n_w = SLOT_POOL[2]
    arrs = synthetic_ragged_windows(len(lengths), max(lengths), 4, lengths=lengths, seed=2, device=device)
    bks = pack_fleet_buckets(*arrs, step_windows=n_w, lengths=lengths, buckets=(1, 2, 4, 8, 16, 32), device=device)
    out["pad_waste_monolithic"] = pad_waste_frac(lengths, n_w)
    out["pad_waste_bucketed"] = bucketed_pad_waste(bks, n_w)
    _log_all("slot pool", out)
    assert out["card_vs_cpu_rel"] <= max(1e-5, 4 * out["cpu_one_ulp_w_rel"]), out
    assert out["admits"] == out["population"], out
    return out


def phase_slot_profile(device="cuda") -> dict:
    """``profile_fleet(slots=64)`` on a 64-node fleet of ragged durations
    (drawn in [900, 1800] s, seed 0; nodes release their slots as their
    streams end), pure and combined: reports within 1e-5 of scale of
    ``profile_fleet`` without slots, every live tick conserved (1e-3 W),
    ticks/s of both."""
    from repro_torch.serving import EnergyFirstControlPlane
    from repro_torch.workload.azure import WorkloadConfig, generate_trace
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    durations = np.random.default_rng(0).integers(SLOT_DURATIONS_S[0], SLOT_DURATIONS_S[1] + 1, size=B_NODES)
    durations[0] = int(DURATION_S)
    traces = [generate_trace(reg, WorkloadConfig(duration_s=float(d), load=1.0, seed=i))
              for i, d in enumerate(durations)]
    cp = EnergyFirstControlPlane(reg, device=device)
    out = {"durations_min_max": [int(durations.min()), int(durations.max())]}
    for mode in ("pure", "combined"):
        runs = {}
        for name, slots in (("plain", None), ("slots", B_NODES)):
            stamps, worst = [], [0.0]

            def on_tick(tk, trackers, stamps=stamps, worst=worst):
                stamps.append(time.perf_counter())
                live = np.ones(B_NODES, bool) if tk.valid is None else tk.valid
                recon = tk.tick_power.sum(-1) + tk.unattributed
                worst[0] = max(worst[0], float(np.abs(recon - tk.target)[live].max()))
                assert not recon[~live].any()

            runs[name] = cp.profile_fleet(traces, mode=mode, slots=slots, on_tick=on_tick)
            _sync(device)
            out[f"{mode}_{name}_ticks_per_s"] = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            out[f"{mode}_{name}_conservation_max_w"] = worst[0]
        out[f"{mode}_slots_vs_plain_rel"] = max(
            _rel(getattr(a.report, f), getattr(p.report, f))
            for a, p in zip(runs["slots"], runs["plain"]) for f in ("x_power", "x_trajectory")
        )
    _log_all("slot profile_fleet", out)
    for mode in ("pure", "combined"):
        assert out[f"{mode}_slots_vs_plain_rel"] <= 1e-5, out
        assert max(out[f"{mode}_{n}_conservation_max_w"] for n in ("plain", "slots")) <= 1e-3, out
    return out


def phase_baselines(device="cuda") -> dict:
    """The paper's baseline profilers (``core/baselines.py``) on the fleet
    phase's 3-node x 300 s data, as benchmarks/fig6_marginal_validation.py
    feeds them (fine-grid activity, the chip signal on that grid, the
    server's 4 s staleness), on the card against the CPU: 1e-5 of scale."""
    from repro_torch.core import baselines
    from repro_torch.core.contribution import contribution_matrix
    from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=300.0, seed=20), 3)
    sims = NodeSimulator(reg, SimulatorConfig(platform=PLATFORM)).simulate_fleet(traces)
    worst = {}
    for tr, sim in zip(traces, sims):
        act = sim.activity.astype(np.float32)
        chip = sim.chip_signal
        idx = np.clip((np.arange(act.shape[0]) * sim.fine_dt * chip.rate_hz).astype(int), 0, len(chip.watts) - 1)
        chip_fine = np.asarray(chip.watts[idx], np.float32)
        inv = np.asarray([tr.invocations_of(j) for j in range(tr.num_fns)], np.float32)
        lat = np.asarray(tr.mean_latency(), np.float32)
        c = contribution_matrix(torch.as_tensor(tr.fn_id, dtype=torch.int64), torch.as_tensor(tr.start),
                                torch.as_tensor(tr.end), num_fns=tr.num_fns, num_windows=300)
        watts = (sim.true_fn_power_w * 1.2).astype(np.float32)  # a model biased by 20 %
        calls = {
            "direct_attribution": lambda d: baselines.direct_attribution(act, chip_fine, sim.fine_dt, lat, inv, device=d),
            "scaphandre_like": lambda d: baselines.scaphandre_like(
                act, chip_fine, sim.fine_dt, inv, sample_bins=int(0.5 / sim.fine_dt),
                stale_bins=int(4.0 / sim.fine_dt), resident_bins=int(10.0 / sim.fine_dt), device=d),
            "model_only_attribution": lambda d: baselines.model_only_attribution(c, 1.0, watts, lat, inv, device=d),
        }
        for name, call in calls.items():
            got, want = call(device), call("cpu")
            assert got.device.type == device and torch.isfinite(got).all(), name
            worst[name] = max(worst.get(name, 0.0), _rel(got, want))
    out = {f"{k}_card_vs_cpu_rel": v for k, v in worst.items()}
    _log_all("baselines", out)
    assert max(worst.values()) <= 1e-5, out
    return out


# ---------------------------------------------------------------------------
# Attention and RMSNorm kernels
# ---------------------------------------------------------------------------


def _elem(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """(bound in ms, what bounds it): bytes over the HBM rate against
    operations over the peak rate of the inputs' type."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_work(b, s, t, h, hkv, d, causal, dtype):
    """(bytes, flops): q, k, v read once and out written once; 2 * 2 * d
    flops per live (q, k) pair (QK^T and PV), counting only the pairs the
    causal mask (offset T - S) leaves live."""
    if causal:
        live = sum(max(0, min(t, i + t - s + 1)) for i in range(s))
    else:
        live = s * t
    nbytes = _elem(dtype) * (2 * b * s * h * d + 2 * b * t * hkv * d)
    return nbytes, 4.0 * b * h * live * d


def decode_work(b, h, hkv, d, lengths, dtype):
    """(bytes, flops): q read and out written once, the K and V rows below
    each length read once (the rest of the cache is never touched), the
    lengths; 2 * 2 * d flops per (query head, live key)."""
    live = sum(lengths)
    nbytes = _elem(dtype) * (2 * b * h * d + 2 * live * hkv * d) + 4 * b
    return nbytes, 4.0 * h * live * d


def rms_work(rows, d, dtype):
    """(bytes, flops): x read once, out written once, gamma (fp32) read
    once; ~4 flops per element (square-add, scale, gain)."""
    return _elem(dtype) * 2 * rows * d + 4 * d, 4.0 * rows * d


def _record(rows, key, err, tol, t_kernel, t_plain, t_lib, work, dtype, label, **more):
    """One parity row; ``more`` holds the variant that ran and the errors
    over the row RMS (``err_rms``, ``planted_err_rms``)."""
    bound, by = _bound(*work, dtype)
    rows[key] = dict(err=err, ms=t_kernel, plain_ms=t_plain, library_ms=t_lib, bound_ms=bound, bound_by=by, **more)
    lib = "n/a" if t_lib is None else f"{t_lib:.5f}"
    extra = "".join(f" {k}={v:.3e}" if isinstance(v, float) else f" {k}={v}" for k, v in more.items())
    log(
        f"parity {label}: max_abs_err={err:.3e} (tol {tol:g}) kernel_ms={t_kernel:.5f} "
        f"plain_ms={t_plain:.5f} library_ms={lib} bound_us={bound * 1e3:.3f} ({by}){extra}"
    )


def _tol(dtype) -> float:
    # fp32: the same fp32 sums in another order (the reference's 2e-5).
    # bf16: both round an fp32 result to bf16 once; outputs up to ~4 differ
    # by at most one bf16 step (2^-7 there) where the orders straddle a
    # rounding boundary (the reference's own bf16 tolerance, 2e-2); bf16
    # attention rows are also held to 2e-2 of their RMS (``_check``).
    return 2e-5 if dtype == torch.float32 else 2e-2


def _check(got, want, tol, what, rows=False) -> float:
    """Max |got - want|, after asserting |got - want| <= atol + tol |want|.
    atol is ``tol``, or with ``rows`` (bf16 attention outputs) ``tol`` times
    the RMS of the reference's row over the last axis, capped at 1: a long
    row's outputs are ~1/sqrt(keys) small, so a fixed atol of 2e-2 would
    pass a wrong key tile there.  Rounding P and the output to bf16 moves a
    row by a few thousandths of its RMS."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if not rows:
        torch.testing.assert_close(g, w, atol=tol, rtol=tol, msg=lambda m: f"{what}: {m}")
        return err
    scale = w.square().mean(-1, keepdim=True).sqrt()
    bad = ~(diff <= tol * scale.clamp(max=1.0) + tol * w.abs())  # NaN is bad
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} elements off by more than {tol:g} of "
                             f"their row's RMS (capped at 1) plus {tol:g} of their value; max abs err {err:.3e}")
    return err


def _row_err(got, want) -> float:
    """Max |got - want| over the reference row's RMS (rows of RMS 0 must be
    exact, which ``_check`` asserts)."""
    w = want.float()
    scale = w.square().mean(-1, keepdim=True).sqrt()
    return float(((got.float() - w).abs() / scale.clamp(min=1e-30)).masked_fill(scale == 0, 0).max())


def _planted_tile_fault(ref, q, k, v, want, tol) -> float:
    """The bf16 check must catch one wrong key tile in long rows: the plain
    version with key tile j = ceil(T / 128) - 2 (K and V) read from tile
    j - 1's keys, as a kernel that reads the wrong ring stage once would
    give; only rows that reach tile j see it.  Returns the fault's max
    error over the row RMS; fails if ``_check`` passes it."""
    j = -(-k.shape[1] // 128) - 2
    kf, vf = k.clone(), v.clone()
    kf[:, j * 128:(j + 1) * 128], vf[:, j * 128:(j + 1) * 128] = k[:, (j - 1) * 128:j * 128], v[:, (j - 1) * 128:j * 128]
    faulty = ref.flash_attention(q, kf, vf, True)
    try:
        _check(faulty, want, tol, "planted fault", rows=True)
    except AssertionError:
        return _row_err(faulty, want)
    raise AssertionError("the bf16 attention check passed a wrong key tile")


def phase_attention_parity(ref) -> dict:
    """The flash, decode and RMSNorm kernels against their plain versions
    (and a library call) at the serving path's shapes and ragged ones."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape, dtype: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol, tag = _tol(dtype), str(dtype).split(".")[1]
        for b, s, t, h, hkv, d, causal in FLASH_MAIN + FLASH_MOE + FLASH_VLM + FLASH_RAGGED:
            q, k, v = rnd(b, s, h, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype)
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, causal)
            bf16 = dtype == torch.bfloat16
            err = _check(got, want, tol, "flash_attention", rows=bf16)
            more = dict(variant=fa.variant(dtype, d))
            if bf16:
                more["err_rms"] = _row_err(got, want)
            if bf16 and (b, s, t, h, hkv, d, causal) in FLASH_MAIN + FLASH_MOE + FLASH_VLM:
                more["planted_err_rms"] = _planted_tile_fault(ref, q, k, v, want, tol)
            reps = 5 if s * t > 2**22 else 25
            t_kernel = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps)
            t_plain = device_ms(lambda: ref.flash_attention(q, k, v, causal), reps)
            t_lib = None
            if s == t or not causal:  # SDPA's causal mask is not offset by T - S
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                t_lib = device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), reps)
            _record(rows, ("flash_attention", (b, s, t, h, hkv, d, causal), tag), err, tol, t_kernel, t_plain,
                    t_lib, flash_work(b, s, t, h, hkv, d, causal, dtype), dtype,
                    f"flash {tag} B={b} S={s} T={t} H={h} Hkv={hkv} d={d} causal={causal}", **more)
        decode_cases = [((b, smax, lengths), H, HKV) for b, smax, lengths in DECODE_MAIN + DECODE_RAGGED]
        decode_cases += [((b, smax, lengths, MOE_H, MOE_HKV), MOE_H, MOE_HKV) for b, smax, lengths in DECODE_MOE]
        for key, h, hkv in decode_cases:
            b, smax, lengths = key[:3]
            q = rnd(b, h, HD, dtype=dtype)
            kc, vc = rnd(b, smax, hkv, HD, dtype=dtype), rnd(b, smax, hkv, HD, dtype=dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got = da.decode_attention(q, kc, vc, lens)
            again = da.decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"decode_attention not deterministic at {key}"
            want = ref.decode_attention(q, kc, vc, lens)
            err = _check(got, want, tol, "decode_attention", rows=dtype == torch.bfloat16)
            more = dict(err_rms=_row_err(got, want)) if dtype == torch.bfloat16 else {}
            timed = time_decode(da, q, kc, vc, lens, warm=key[:3] in DECODE_MAIN + DECODE_MOE)
            t_kernel, t_lib = timed.pop("ms"), timed.pop("library_ms")
            more.update(timed)
            t_plain = device_ms(lambda: ref.decode_attention(q, kc, vc, lens))
            _record(rows, ("decode_attention", key, tag), err, tol, t_kernel, t_plain, t_lib,
                    decode_work(b, h, hkv, HD, lengths, dtype), dtype,
                    f"decode {tag} B={b} S_max={smax} H={h} Hkv={hkv} lengths={list(lengths)}", **more)
        for n, d in RMS_MAIN + RMS_RAGGED:
            x, g = rnd(n, d, dtype=dtype), rnd(d, dtype=torch.float32)
            got = rn.rmsnorm(x, g)
            torch.cuda.synchronize()
            tol_rms = 1e-5 if dtype == torch.float32 else 2e-2  # the reference's RMSNorm tolerances
            err = _check(got, ref.rmsnorm(x, g), tol_rms, "rmsnorm")
            g_lib = g.to(dtype)
            t_kernel = device_ms(lambda: rn.rmsnorm(x, g))
            t_plain = device_ms(lambda: ref.rmsnorm(x, g))
            t_lib = device_ms(lambda: F.rms_norm(x, (d,), g_lib, 1e-5))
            _record(rows, ("rmsnorm", (n, d), tag), err, tol_rms, t_kernel, t_plain, t_lib,
                    rms_work(n, d, dtype), dtype, f"rmsnorm {tag} rows={n} d={d}",
                    variant=rn.variant(dtype, d))
    return rows


# ---------------------------------------------------------------------------
# Serving path
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_model(device="cuda", reduced=False, arch=ARCH, layers=None):
    """``arch`` (full width unless ``reduced``; ``layers`` cuts the depth):
    fp32 masters from a seeded generator on ``device``, and the bf16
    compute copy (the leaves the reference reads in fp32 stay fp32)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build
    from repro_torch.models.common import cast_params, materialize

    cfg = get_config(arch, reduced=reduced)
    if layers is not None:
        log(f"model {cfg.name}: depth cut from {cfg.num_layers} to {layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    api = build(cfg)
    t0 = time.perf_counter()
    masters = materialize(api.params_def, torch.Generator(device=device).manual_seed(0), torch.float32)
    params = cast_params(masters, torch.bfloat16)
    _sync(device)
    n = sum(p.numel() for p in params.parameters())
    log(f"model {api.cfg.name}: {n:,} parameters, {api.cfg.num_layers} layers, d_model {api.cfg.d_model}, "
        f"vocab {api.cfg.padded_vocab} (padded); init {time.perf_counter() - t0:.2f} s")
    return api, masters, params


def phase_serving(api, params, classes=CLASSES, schedule=SCHEDULE, device="cuda"):
    """Serve the schedule through MeteredServer, meter and price the trace."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.serve import meter_trace, random_batch
    from repro_torch.serving.control_plane import MeteredServer
    from repro_torch.serving.engine import ServeEngine

    rng = np.random.default_rng(0)
    server = MeteredServer()
    for name, c in classes.items():
        shape = ShapeConfig(name, c["prompt"], c["batch"], "prefill")
        server.register(name, ServeEngine(api, shape, params), random_batch(api, shape, rng, device),
                        steps=c["steps"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace = server.serve([(name, 0.0) for name in schedule], duration=60.0)
    serve_s = time.perf_counter() - t0
    report, prices = meter_trace(server, trace, device=device)
    _sync(device)
    total = float(report.spectrum.j_indiv.sum()) + report.cp_energy + report.idle_energy
    eff = abs(float(report.spectrum.j_total.sum()) - total) / total
    return dict(server=server, trace=trace, report=report, prices=prices, serve_s=serve_s, eff=eff,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan"))


def report_serving(out, classes=CLASSES) -> dict:
    """Per class: warm latency, prefill and decode tokens/s (a separate
    prefill-only timing of the same batch), J/inv and usd/inv."""
    server, trace, report, prices = out["server"], out["trace"], out["report"], out["prices"]
    lat = trace.end - trace.start
    stats = {}
    for i, name in enumerate(server.order):
        engine, batch, steps = server.functions[name]
        c = classes[name]
        warm = lat[trace.fn_id == i]
        pre = []
        for _ in range(3):
            engine.prefill(batch)
            pre.append(engine.records[-1].latency)
        pre_s = statistics.median(pre)
        decode_s = float(np.mean(warm)) - pre_s
        stats[name] = dict(
            requests=int(warm.size), first_s=float(warm[0]), mean_s=float(np.mean(warm)), p95_s=float(np.quantile(warm, 0.95)),
            prefill_s=pre_s, prefill_tok_s=c["batch"] * c["prompt"] / pre_s,
            decode_tok_s=c["batch"] * (steps - 1) / decode_s,
            j_inv=float(report.spectrum.per_invocation[i]), usd_inv=float(prices["total_usd_per_inv"][i]),
        )
        st = stats[name]
        log(
            f"serve {name}: requests={st['requests']} warm_latency mean_s={st['mean_s']:.4f} "
            f"p95_s={st['p95_s']:.4f} prefill_s={pre_s:.4f} prefill_tok_s={st['prefill_tok_s']:.1f} "
            f"decode_tok_s={st['decode_tok_s']:.1f} J_inv={st['j_inv']:.3f} usd_inv={st['usd_inv']:.3e}"
        )
    log(f"serve: {trace.num_invocations} requests in {out['serve_s']:.2f} s ({len(classes)} cold starts included); "
        f"footprint efficiency rel err {out['eff']:.3e}; total_error={report.total_error:.4f}; "
        f"max_memory_allocated {out['peak_gb']:.2f} GiB")
    return stats


def phase_rmsnorm_path(api, params, hidden: list):
    """``ops.rmsnorm`` (the kernel on the card) on the served model's final
    hidden states, against the plain ``rms_norm`` the model's final norm
    uses."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import rms_norm

    errs = []
    for h in hidden:
        got = ops.rmsnorm(h, params["ln_f"], api.cfg.norm_eps)
        _sync(h.device)
        errs.append(_check(got, rms_norm(h, params["ln_f"], api.cfg.norm_eps), 2e-2, "rmsnorm path"))
    return max(errs)


def final_hidden(api, params, classes=CLASSES, device="cuda") -> list:
    """Each class's final hidden states (before ln_f) over its served prompt."""
    from repro_torch.models.transformer import _positions, decoder_hidden, embed_tokens

    out = []
    rng = np.random.default_rng(0)  # the prompts phase_serving drew
    with torch.no_grad():
        for c in classes.values():
            tokens = torch.as_tensor(rng.integers(0, api.cfg.vocab_size, size=(c["batch"], c["prompt"])),
                                     dtype=torch.int32, device=device)
            h = embed_tokens(params, tokens, api.cfg)
            out.append(decoder_hidden(params, h, _positions(*tokens.shape, device), api.cfg)[0])
    return out


def _full_forward(api, params, batch):
    """The full forward's logits over a prompt batch (patches included)."""
    from repro_torch.models.transformer import decoder_train
    from repro_torch.models.xlstm import xlstm_train

    if api.cfg.family == "ssm":
        return xlstm_train(params, batch["tokens"], api.cfg)[0]
    return decoder_train(params, batch["tokens"], api.cfg, prefix_embeds=batch.get("patches"))[0]


def _check_api(api, fp32=False):
    """The consistency checks' model: MoE at capacity factor 8, as the
    reference's ``tests/test_models.py`` has it, so that no token is dropped
    in the batched forward or the one-token decode; ``fp32`` compute."""
    import dataclasses

    from repro_torch.models import build

    cfg = api.cfg
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if fp32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return build(cfg)


def _prompt(api, rng, b, s, device):
    """A prompt of ``s`` tokens (after the VLM's patch embeddings, drawn in
    fp32) from ``rng``."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.serve import random_batch

    return random_batch(api, ShapeConfig("check", s + api.cfg.frontend_tokens, b, "prefill"), rng, device)


def check_fp32(api, masters, device="cuda") -> dict:
    """The reference's serving invariant at full width in fp32 from the
    masters, through the kernels: prefill's last logits against the full
    forward (2e-3), one decode step against the full forward over the
    extended prompt (5e-3)."""
    from repro_torch.models import extend_cache
    from repro_torch.models.model_zoo import prompt_length

    api32 = _check_api(api, fp32=True)
    b, s = 2, 64
    rng = np.random.default_rng(1)
    batch = _prompt(api32, rng, b, s, device)
    tok = torch.as_tensor(rng.integers(0, api32.cfg.vocab_size, size=(b, 1)), dtype=torch.int32, device=device)
    with torch.no_grad():
        logits_pf, cache = api32.prefill(masters, batch)
        full = _full_forward(api32, masters, batch)[:, -1]
        cache = extend_cache(api32, cache, 4)
        logits_dec, _ = api32.decode(masters, cache, tok, prompt_length(batch))
        full2 = _full_forward(api32, masters, dict(batch, tokens=torch.cat([batch["tokens"], tok], dim=1)))[:, -1]
    torch.testing.assert_close(logits_pf[:, 0], full, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(logits_dec[:, 0], full2, atol=5e-3, rtol=5e-3)
    out = dict(prefill_err=float((logits_pf[:, 0] - full).abs().max()),
               decode_err=float((logits_dec[:, 0] - full2).abs().max()), scale=float(full2.abs().max()))
    log(f"consistency {api.cfg.name} fp32 full width: prefill vs forward max_abs {out['prefill_err']:.3e} (2e-3), "
        f"decode vs forward max_abs {out['decode_err']:.3e} (5e-3), logit scale {out['scale']:.3f}")
    return out


def _routes(api, params, batch) -> list:
    """Each MoE layer's top-k expert indices over a prefill of ``batch``."""
    from repro_torch.models import moe

    seen, router = [], moe._router

    def recording(p, x, cfg):
        out = router(p, x, cfg)
        seen.append(out[0])
        return out

    moe._router = recording
    try:
        with torch.no_grad():
            api.prefill(params, batch)
    finally:
        moe._router = router
    return seen


def kernels_vs_plain(api, masters, params, ref, device="cuda") -> dict:
    """16 greedy steps with the kernels against the plain versions patched
    into ``ops``: equal tokens in fp32, and in bf16 the logits' distance
    from fp32 compute for both (the kernels' at most 1.5x the plain
    versions').  For MoE, the share of (token, expert) routing choices that
    bf16 and fp32 compute make alike."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine

    api, api32 = _check_api(api), _check_api(api, fp32=True)
    steps = 16
    rng = np.random.default_rng(3)
    batch = _prompt(api32, rng, 2, 128, device)
    shape = ShapeConfig("check", 128 + api.cfg.frontend_tokens, 2, "prefill")
    engine, engine32 = ServeEngine(api, shape, params), ServeEngine(api32, shape, masters)
    with torch.no_grad():
        logits_k, _ = api.prefill(params, batch)
    toks_k, toks32_k = engine.generate(batch, steps), engine32.generate(batch, steps)
    flash, decode = ops.flash_attention, ops.decode_attention
    ops.flash_attention = lambda q, k, v, *, causal=True, q_block=512, kv_block=1024: ref.flash_attention(
        q, k, v, causal, q_block, kv_block)
    ops.decode_attention = lambda q, kc, vc, lengths, *, kv_block=2048: ref.decode_attention(q, kc, vc, lengths)
    try:
        with torch.no_grad():
            logits_p, _ = api.prefill(params, batch)
        toks_p, toks32_p = engine.generate(batch, steps), engine32.generate(batch, steps)
    finally:
        ops.flash_attention, ops.decode_attention = flash, decode
    name = api.cfg.name
    # fp32 compute: the kernels and the plain versions differ only in the
    # order of fp32 sums, so the greedy tokens must agree.
    assert torch.equal(toks32_k, toks32_p), (toks32_k, toks32_p)
    log(f"consistency {name} fp32 greedy tokens, kernels vs plain: {toks32_k.numel()}/{toks32_k.numel()} equal")
    with torch.no_grad():
        logits_32, _ = api32.prefill(masters, batch)  # the same prompt in fp32 compute
    agree = int((toks_k == toks_p).sum())
    same = (toks_k == toks_p).all(dim=0)
    first = int((~same).nonzero()[0]) if not bool(same.all()) else steps
    gap = lambda x: float((x.float() - logits_32).abs().max())
    out = dict(gap_kernels=gap(logits_k), gap_plain=gap(logits_p), tokens_equal=agree, first_diff=first)
    log(f"consistency {name} bf16 kernels vs plain: prefill logits max_abs "
        f"{float((logits_k - logits_p).float().abs().max()):.3e} "
        f"(scale {float(logits_p.float().abs().max()):.3f}; bf16 vs fp32 compute: kernels {out['gap_kernels']:.3e}, "
        f"plain {out['gap_plain']:.3e}); greedy tokens equal {agree}/{toks_k.numel()}, "
        f"identical for the first {first} of {steps} steps")
    if api.cfg.family == "moe":
        bf16, fp32 = _routes(api, params, batch), _routes(api32, masters, batch)
        shared = [float((a[:, :, None] == b[:, None, :]).any(-1).float().mean()) for a, b in zip(bf16, fp32)]
        out["routing_shared"] = float(np.mean(shared))
        log(f"consistency {name} routing: bf16 and fp32 compute share {out['routing_shared']:.4f} of the "
            f"(token, expert) choices over {len(shared)} layers (per layer {min(shared):.4f}-{max(shared):.4f})")
    # The tensor-core flash kernel rounds P to bf16 before P V; that may add
    # error beyond the plain version's fp32 P, but not half as much again.
    assert out["gap_kernels"] <= 1.5 * out["gap_plain"], (out["gap_kernels"], out["gap_plain"])
    return out


def phase_consistency(api, masters, params, ref, device="cuda") -> dict:
    """The reference's serving invariant at full width in fp32 through the
    kernels, then bf16 with the kernels against bf16 with the plain versions."""
    out = check_fp32(api, masters, device)
    out.update(kernels_vs_plain(api, masters, params, ref, device))
    return out


# ---------------------------------------------------------------------------
# Model families: MoE, xLSTM, VLM, the int8 KV cache
# ---------------------------------------------------------------------------


def serve_path(api, params, classes, schedule, counter, ref, device="cuda"):
    """Serve ``schedule`` (counts zeroed just before, read just after, the
    plain versions watched), then report it.  Returns (serving output,
    stats, launch counts)."""
    with main_path(ref):
        counter.zero()
        out = phase_serving(api, params, classes, schedule, device)
        launches = counter.read()
    return out, report_serving(out, classes), launches


def expected_launches(api, classes, schedule) -> tuple[int, int]:
    """(flash, decode) launches of serving ``schedule``: one each per
    attention layer per prefill (every request and each class's cold start)
    and per decode step."""
    layers = api.cfg.num_layers if api.cfg.family != "ssm" else 0
    prefills = len(schedule) + len(classes)
    return layers * prefills, layers * sum(classes[n]["steps"] - 1 for n in schedule)


def gated_decode(api, params, batch, label, ref, device="cuda") -> None:
    """One decode step (after a warm one) with every implicit host
    synchronisation an error (``set_sync_debug_mode("error")``), the plain
    versions watched."""
    from repro_torch.models import extend_cache
    from repro_torch.models.model_zoo import prompt_length

    cuda = torch.device(device).type == "cuda"
    with torch.no_grad(), main_path(ref):
        logits, cache = api.prefill(params, batch)
        cache = extend_cache(api, cache, 2)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        pos = prompt_length(batch)
        api.decode(params, cache, tok, pos)
        _sync(device)
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = api.decode(params, cache, tok, pos + 1)
            nxt = torch.argmax(logits[:, -1], dim=-1)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        _sync(device)
    assert bool(torch.isfinite(logits).all()) and nxt.shape == (batch["tokens"].shape[0],)
    log(f"sync gate {label}: one decode step (B={nxt.shape[0]}, pos {pos + 1}) with no host synchronisation")


def phase_int8(api, params, counter, ref, device="cuda") -> dict:
    """The int8 KV cache on the served internlm2 weights, chat class: the
    reference's pins (``tests/test_perf_features.py``: decode logits against
    the unquantized cache's, cosine > 0.999 and argmax equal), greedy tokens
    against the unquantized cache, cache bytes, then 3 requests served and
    one decode step under the sync gate."""
    import dataclasses

    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.serve import random_batch
    from repro_torch.models import build, extend_cache
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv_cache import cache_bytes

    api_q = build(dataclasses.replace(api.cfg, kv_cache_dtype="int8"))
    c = CLASSES[f"{ARCH}/chat"]
    shape = ShapeConfig("int8", c["prompt"], c["batch"], "prefill")
    batch = random_batch(api, shape, np.random.default_rng(2), device)
    with torch.no_grad():
        lg, cache = api.prefill(params, batch)
        _, cache_q = api_q.prefill(params, batch)
        cache, cache_q = extend_cache(api, cache, 2), extend_cache(api_q, cache_q, 2)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        d1, _ = api.decode(params, cache, tok, c["prompt"])
        d2, _ = api_q.decode(params, cache_q, tok, c["prompt"])
    d1, d2 = d1.float(), d2.float()
    out = dict(cos=float((d1 * d2).sum() / (d1.norm() * d2.norm())),
               argmax_equal=bool(torch.equal(d1[:, -1].argmax(-1), d2[:, -1].argmax(-1))))
    t_bf16 = ServeEngine(api, shape, params).generate(batch, c["steps"])
    t_int8 = ServeEngine(api_q, shape, params).generate(batch, c["steps"])
    same = (t_bf16 == t_int8).all(dim=0)
    out["steps_identical"] = int((~same).nonzero()[0]) if not bool(same.all()) else c["steps"]
    out["tokens_equal"] = int((t_bf16 == t_int8).sum())
    full = ShapeConfig("int8", c["prompt"] + c["steps"], c["batch"], "prefill")
    out["cache_bytes"], out["cache_bytes_bf16"] = cache_bytes(api_q, full), cache_bytes(api, full)
    log(f"int8 cache {api.cfg.name}: decode logits vs the bf16 cache cosine {out['cos']:.6f} (> 0.999), "
        f"argmax equal {out['argmax_equal']}; greedy tokens equal {out['tokens_equal']}/{t_bf16.numel()}, "
        f"identical for the first {out['steps_identical']} of {c['steps']} steps; cache bytes "
        f"{out['cache_bytes']:,} against bf16 {out['cache_bytes_bf16']:,} "
        f"({out['cache_bytes'] / out['cache_bytes_bf16']:.4f})")
    assert out["cos"] > 0.999 and out["argmax_equal"], out
    serve_out, out["stats"], out["launches"] = serve_path(api_q, params, INT8_CLASSES, INT8_SCHEDULE, counter, ref,
                                                          device)
    out["eff"] = serve_out["eff"]
    gated_decode(api_q, params, batch, f"{ARCH} int8 cache", ref, device)
    return out


def phase_family(arch, classes, schedule, counter, ref, device="cuda", reduced=False,
                 gate=False, vs_plain=False, trace=False) -> dict:
    """Build ``arch`` at full width (fp32 masters and the bf16 copy), serve
    ``schedule`` through ``MeteredServer``, meter and price it; with
    ``trace``, trace one warm request per class (device busy per request);
    check the fp32 invariants (and, with ``vs_plain``, kernels against
    plain versions); with ``gate``, one decode step under the sync gate;
    then free the weights."""
    from repro_torch.launch.serve import random_batch
    from repro_torch.configs.shapes import ShapeConfig

    t0 = time.perf_counter()
    api, masters, params = build_model(device, reduced, arch)
    cuda = torch.device(device).type == "cuda"
    serve_out, stats, launches = serve_path(api, params, classes, schedule, counter, ref, device)
    log(f"family {arch}: built and served in {time.perf_counter() - t0:.1f} s")
    out = dict(arch=api.cfg.name, layers=api.cfg.num_layers, stats=stats, launches=launches, eff=serve_out["eff"],
               peak_gb=serve_out["peak_gb"], expected=expected_launches(api, classes, schedule),
               params=sum(p.numel() for p in params.parameters()))
    if cuda and trace:
        server = serve_out["server"]
        replays = {}
        for name in classes:
            engine, batch, steps = server.functions[name]
            replays[f"serve {name}"] = (lambda e=engine, b=batch, n=steps: e.generate(b, n), stats[name]["first_s"])
        phase_trace(replays)
        log(f"family {arch}: traced at {time.perf_counter() - t0:.1f} s")
    out["fp32"] = check_fp32(api, masters, device)
    if vs_plain:
        out.update(kernels_vs_plain(api, masters, params, ref, device))
        log(f"family {arch}: kernels against plain versions done at {time.perf_counter() - t0:.1f} s")
    if gate:
        c = next(iter(classes.values()))
        rng = np.random.default_rng(4)
        batch = random_batch(api, ShapeConfig("gate", c["prompt"], c["batch"], "prefill"), rng, device)
        gated_decode(api, params, batch, api.cfg.name, ref, device)
    del serve_out, masters, params
    if cuda:
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase family {arch}: {out['phase_s']:.1f} s")
    return out


def phase_deepseek(counter, ref, device="cuda", reduced=False) -> dict:
    """deepseek-moe-16b at full width, depth cut to ``DEEPSEEK_LAYERS``
    (dense layer 0 and its k0/v0 cache, shared experts): one prefill and 16
    decode steps, then the fp32 invariants."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.serve import random_batch
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    api, masters, params = build_model(device, reduced, DEEPSEEK, None if reduced else DEEPSEEK_LAYERS)
    assert "dense0" in params and "shared" in params["layers"][0]["mixer"]
    c = DEEPSEEK_CLASS
    shape = ShapeConfig("deepseek", c["prompt"], c["batch"], "prefill")
    engine = ServeEngine(api, shape, params)
    batch = random_batch(api, shape, np.random.default_rng(5), device)
    engine.warmup(batch)
    with main_path(ref):
        counter.zero()
        toks = engine.generate(batch, c["steps"])
        launches = counter.read()
    wall = engine.records[-1].latency
    out = dict(arch=api.cfg.name, layers=api.cfg.num_layers, launches=launches, wall_s=wall,
               expected=(api.cfg.num_layers, api.cfg.num_layers * (c["steps"] - 1)),
               params=sum(p.numel() for p in params.parameters()))
    assert toks.shape == (c["batch"], c["steps"])
    log(f"serve {api.cfg.name} (depth {api.cfg.num_layers}: dense0 + {api.cfg.num_layers - 1} MoE layers, "
        f"{out['params']:,} parameters): one prefill (B={c['batch']}, prompt {c['prompt']}) and "
        f"{c['steps'] - 1} decode steps in {wall:.4f} s; launches {launches}")
    out["fp32"] = check_fp32(api, masters, device)
    del masters, params, engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase family {DEEPSEEK}: {out['phase_s']:.1f} s")
    return out


def phase_launcher(ref, device="cuda") -> str:
    """``python -m repro_torch.launch.serve`` with its defaults (the
    reference's mix, reduced configs) on ``device``: every architecture
    served, none skipped."""
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), main_path(ref):
        serve.main(["--requests", "6", "--device", device])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"launcher | {line}")
    assert "skipped" not in text
    for name in ("internlm2-1.8b", "xlstm-350m", "olmoe-1b-7b"):
        assert f"{name}/generate registered" in text, name
    return text


class LaunchCounter:
    """Zero and read the hand kernels' launch counts (a path's counts are
    zeroed just before it and read just after)."""

    def __init__(self, fa, da, rn, ds):
        self.fns = dict(flash=fa.flash_attention, decode=da.decode_attention, rmsnorm=rn.rmsnorm,
                        gram=ds.disagg_gram)

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0
        self.fns["flash"].launches_tc = 0

    def read(self) -> dict:
        out = {k: fn.launches for k, fn in self.fns.items()}
        out["flash_tc"] = self.fns["flash"].launches_tc
        return out


def phase_families(ref, counter, device="cuda", reduced=False) -> dict:
    """olmoe-1b-7b, deepseek-moe-16b (depth cut), xlstm-350m, internvl2-2b,
    then the launcher's defaults; each path watched and counted on its own."""
    t0 = time.perf_counter()
    fam: dict = {}
    fam["olmoe"] = phase_family(OLMOE, OLMOE_CLASSES, OLMOE_SCHEDULE, counter, ref, device, reduced,
                                gate=True, vs_plain=True, trace=True)
    fam["deepseek"] = phase_deepseek(counter, ref, device, reduced)
    fam["xlstm"] = phase_family(XLSTM, XLSTM_CLASSES, XLSTM_SCHEDULE, counter, ref, device, reduced, gate=True)
    fam["vlm"] = phase_family(VLM, VLM_CLASSES, VLM_SCHEDULE, counter, ref, device, reduced)
    t1 = time.perf_counter()
    counter.zero()
    phase_launcher(ref, device)
    fam["launcher"] = dict(launches=counter.read(), phase_s=time.perf_counter() - t1)
    fam["phase_s"] = time.perf_counter() - t0
    log(f"phase launcher defaults: {fam['launcher']['phase_s']:.1f} s; phase model families: {fam['phase_s']:.1f} s")
    return fam


def check_families(fam, int8_layers) -> None:
    """Every family path launched what its layers and requests make, bf16
    flash on the tensor-core kernel; the int8 path no decode kernel."""
    int8 = fam["int8"]["launches"]
    assert int8["flash"] == int8_layers * (len(INT8_SCHEDULE) + 1) == int8["flash_tc"], int8
    assert int8["decode"] == 0, f"the int8 cache's decode runs the reference's plain path: {int8}"
    assert fam["int8"]["eff"] <= 1e-5, fam["int8"]["eff"]
    for key in ("olmoe", "xlstm", "vlm", "deepseek"):
        got, (flash_want, decode_want) = fam[key]["launches"], fam[key]["expected"]
        assert (got["flash"], got["decode"]) == (flash_want, decode_want), (key, got, flash_want, decode_want)
        assert got["flash_tc"] == got["flash"], (key, got)
        assert fam[key].get("eff", 0.0) <= 1e-5, (key, fam[key]["eff"])
        log(f"serve launches {fam[key]['arch']}: flash_attention {got['flash']} (tensor-core {got['flash_tc']}), "
            f"decode_attention {got['decode']}")
    assert fam["launcher"]["launches"]["flash"] > 0 and fam["launcher"]["launches"]["decode"] > 0, fam["launcher"]
    log("families " + json.dumps(fam, default=str))


PLAIN_NAMES = ("disagg_gram", "flash_attention", "decode_attention", "rmsnorm")


@contextlib.contextmanager
def main_path(ref):
    """Watch the plain versions while a main path runs: a CUDA tensor that
    reaches one fails the run.  The int8 cache's ``ref.quantize_kv`` and
    ``ref.decode_attention_quant`` are not watched: they are the
    reference's own int8 path, which has no Pallas kernel and calls them
    directly on every device, not plain stand-ins for a kernel."""
    calls, restore = _watch_plain(ref, PLAIN_NAMES)
    try:
        yield
    finally:
        restore()
    assert not [c for c in calls if c[1] == "cuda"], calls


def _watch_plain(ref, names):
    """Wrap the named plain versions so each call records its device;
    returns (calls, restore)."""
    calls: list = []
    saved = {n: getattr(ref, n) for n in names}

    def wrap(n, fn):
        def watched(x, *args, **kwargs):
            calls.append((n, x.device.type))
            return fn(x, *args, **kwargs)
        return watched

    for n, fn in saved.items():
        setattr(ref, n, wrap(n, fn))

    def restore():
        for n, fn in saved.items():
            setattr(ref, n, fn)

    return calls, restore


def _summary(name, replaces, launches, main, shapes, source=None, **extra):
    """One kernel's entry of the ``kernels`` line: its main-path shapes'
    rows summed (times, bounds) or maxed (error); for a kernel with
    variants, the one that ran."""
    entry = {
        "name": name,
        "route": "cuda",
        "source": source or f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["err"] for r in main),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main) else "operations",
        "library_ms": sum(r["library_ms"] for r in main),
        "shapes": json.loads(json.dumps(shapes)),  # tuples as lists
        "ms_per_shape": [r["ms"] for r in main],
    }
    if all("warm_ms" in r for r in main):
        entry["warm_ms"] = sum(r["warm_ms"] for r in main)
        entry["library_warm_ms"] = sum(r["library_warm_ms"] for r in main)
    if "variant" in main[0]:
        entry["variant"] = "+".join(sorted({r["variant"] for r in main}))
    entry.update(extra)
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import disagg_solve as ds
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ref
        from repro_torch.kernels import rmsnorm as rn
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {SRC}: {exc}", file=sys.stderr)
        return 2
    counted = (ds.disagg_gram, fa.flash_attention, da.decode_attention, rn.rmsnorm)
    plain_names = PLAIN_NAMES

    counter = LaunchCounter(fa, da, rn, ds)
    zero_counts = counter.zero

    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = phase_build()
    t0 = time.perf_counter()
    rows = phase_kernel_parity(ds, ref)
    arows = phase_attention_parity(ref)
    log(f"phase kernel parity: {time.perf_counter() - t0:.1f} s")

    # Fleet metering path: counts zeroed just before, read just after; the
    # plain versions are watched so a CUDA tensor provably never reaches one.
    t0 = time.perf_counter()
    plain_calls, restore = _watch_plain(ref, plain_names)
    zero_counts()
    try:
        main_out, replays, fleet = phase_main_path("cuda")
    finally:
        restore()
    gram_launches = ds.disagg_gram.launches
    assert gram_launches == 2, f"run_fleet_gram should launch disagg_gram twice (X_0 + step hoist), got {gram_launches}"
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    assert main_out["gram_vs_raw_max_abs"] <= 5e-5 * max(1.0, main_out["x_final_max"]), main_out
    for k, v in main_out.items():
        log(f"main_path {k}: {v}")
    log(f"main_path disagg_gram launches: {gram_launches}")
    phase_trace(replays)
    worst = phase_small_agreement()
    log(f"small fleet card vs cpu: max rel diff {worst:.3e}")
    log(f"phase fleet path: {time.perf_counter() - t0:.1f} s")

    # Streaming control plane: the reference's streaming path reaches no
    # Pallas kernel (no gram_fn on it), so none of the hand kernels may
    # launch while it runs; counts zeroed just before, read just after.
    t0 = time.perf_counter()
    plain_calls, restore = _watch_plain(ref, plain_names)
    zero_counts()
    try:
        stream_out = phase_stream_engine(fleet)
        gate_out, gate_reports = phase_stream_gate(fleet)
        stream_out.update(gate_out)
        stream_out.update(phase_control_plane(fleet, gate_reports))
        stream_out["card_vs_cpu_rel"] = phase_stream_small_agreement()
        stream_out.update(phase_stream_trace(fleet))
    finally:
        restore()
    stream_launches = {fn.__name__: fn.launches for fn in counted}
    log(f"streaming card_vs_cpu_rel: {stream_out['card_vs_cpu_rel']:.3e}; hand-kernel launches {stream_launches}")
    assert not any(stream_launches.values()), stream_launches
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    assert stream_out["card_vs_cpu_rel"] <= 1e-5, stream_out["card_vs_cpu_rel"]
    del gate_reports
    log(f"phase streaming control plane: {time.perf_counter() - t0:.1f} s")

    metrics: dict = {}
    # Combined metering (§4.3).  As in the reference, fleet_profile_batched
    # (run_fleet) and the combined session (no gram_fn) launch no hand
    # kernel; the combined target's run_fleet_gram launches the gram, at the
    # fleet shapes and at the controller shape (M = 128).  Counts zeroed
    # just before each part, read just after.
    t0 = time.perf_counter()
    plain_calls, restore = _watch_plain(ref, plain_names)
    try:
        zero_counts()
        metrics["combined_batched"], comb_reports = phase_combined_batched(fleet)
        metrics["combined_stream"] = phase_combined_stream(fleet, comb_reports)
        metrics["combined_gate"] = phase_combined_gate(fleet)
        metrics["combined_mixed"] = phase_combined_mixed()
        comb_quiet = {fn.__name__: fn.launches for fn in counted}
        zero_counts()
        metrics["combined_engine"] = phase_combined_engine(fleet)
        comb_fleet_gram = ds.disagg_gram.launches
        zero_counts()
        metrics["combined_controller"] = phase_combined_controller()
        comb_ctrl_gram = ds.disagg_gram.launches
        comb_ctrl_other = {fn.__name__: fn.launches for fn in counted if fn is not ds.disagg_gram}
    finally:
        restore()
    log(f"combined hand-kernel launches: batched + stream + gate + mixed {comb_quiet}; "
        f"disagg_gram {comb_fleet_gram} (fleet combined target), {comb_ctrl_gram} (controller shape)")
    assert not any(comb_quiet.values()), comb_quiet
    assert comb_fleet_gram == 2 and comb_ctrl_gram == 2 * metrics["combined_controller"]["gram_calls"], (
        comb_fleet_gram, comb_ctrl_gram)
    assert not any(comb_ctrl_other.values()), comb_ctrl_other
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    del comb_reports
    metrics["combined_phase_s"] = time.perf_counter() - t0
    log(f"phase combined metering: {metrics['combined_phase_s']:.1f} s")

    # Closed control loop: the streaming path again, so no hand kernel.
    t0 = time.perf_counter()
    plain_calls, restore = _watch_plain(ref, plain_names)
    zero_counts()
    try:
        metrics["control"] = phase_control()
    finally:
        restore()
    control_launches = {fn.__name__: fn.launches for fn in counted}
    assert not any(control_launches.values()), control_launches
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    metrics["control_phase_s"] = time.perf_counter() - t0
    log(f"phase control loop: {metrics['control_phase_s']:.1f} s; hand-kernel launches {control_launches}")
    log("combined_control " + json.dumps(metrics))

    # Elastic serving.  Length buckets launch the gram once for X_0 and once
    # for the step hoist per bucket, the sharded run_fleet_gram once each per
    # shard; the slot pool, profile_fleet(slots=) (the streaming path) and
    # the baselines launch no hand kernel.  Counts zeroed just before each
    # part, read just after; the gram's inputs at every shape it launched
    # are kept for the parity that follows.
    t0 = time.perf_counter()
    elastic: dict = {}
    gram_kernel = ds.disagg_gram
    plain_calls, restore = _watch_plain(ref, plain_names)
    seen, unrecord = _record_gram()
    try:
        zero_counts()
        elastic["buckets"] = phase_elastic_buckets(fleet, lambda: gram_kernel.launches)
        elastic["mesh"] = phase_elastic_mesh(fleet, lambda: gram_kernel.launches)
        elastic_gram = gram_kernel.launches
        elastic_other = {fn.__name__: fn.launches for fn in counted if fn is not gram_kernel}
        zero_counts()
        elastic["slot_pool"] = phase_slot_pool()
        elastic["slot_profile_fleet"] = phase_slot_profile()
        elastic["baselines"] = phase_baselines()
        elastic_quiet = {fn.__name__: fn.launches for fn in counted}
    finally:
        unrecord()
        restore()
    log(f"elastic hand-kernel launches: buckets + mesh disagg_gram {elastic_gram}, others {elastic_other}; "
        f"slot pool + slot profile_fleet + baselines {elastic_quiet}")
    assert elastic_gram > 0 and not any(elastic_other.values()), (elastic_gram, elastic_other)
    assert not any(elastic_quiet.values()), elastic_quiet
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    log(f"elastic gram shapes launched: {sorted(seen)}")
    elastic_rows = {shape: gram_parity(ds, ref, c, w, warm=True, label="elastic parity")
                    for shape, (c, w) in sorted(seen.items())}
    del seen, fleet
    elastic["phase_s"] = time.perf_counter() - t0
    log(f"phase elastic serving: {elastic['phase_s']:.1f} s")
    log("elastic " + json.dumps(elastic, default=str))

    # Serving path: same discipline.
    t0 = time.perf_counter()
    api, masters, params = build_model()
    plain_calls, restore = _watch_plain(ref, plain_names)
    zero_counts()
    try:
        serve_out = phase_serving(api, params)
    finally:
        restore()
    flash_launches, decode_launches = fa.flash_attention.launches, da.decode_attention.launches
    flash_tc = fa.flash_attention.launches_tc
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    layers = api.cfg.num_layers
    prefills = len(SCHEDULE) + len(CLASSES)  # every request + each class's cold start
    decode_steps = sum(CLASSES[n]["steps"] - 1 for n in SCHEDULE)
    assert flash_launches == layers * prefills, (flash_launches, layers, prefills)
    assert flash_tc == flash_launches, f"bf16 serving flash launches not on the tensor-core kernel: {flash_tc} of {flash_launches}"
    assert decode_launches == layers * decode_steps, (decode_launches, layers, decode_steps)
    assert serve_out["eff"] <= 1e-5, serve_out["eff"]
    log(f"serve launches: flash_attention {flash_launches} = {layers} layers x {prefills} prefills "
        f"({flash_tc} on the tensor-core kernel); "
        f"decode_attention {decode_launches} = {layers} layers x {decode_steps} decode steps")
    stats = report_serving(serve_out)
    log(f"phase serving path: {time.perf_counter() - t0:.1f} s")

    # RMSNorm path: ops.rmsnorm on the served model's final hidden states.
    hidden = final_hidden(api, params)
    plain_calls, restore = _watch_plain(ref, plain_names)
    zero_counts()
    try:
        rms_err = phase_rmsnorm_path(api, params, hidden)
    finally:
        restore()
    rms_launches = rn.rmsnorm.launches
    assert rms_launches == len(hidden), rms_launches
    assert not plain_calls, plain_calls
    log(f"rmsnorm path: {rms_launches} launches on final hidden states "
        f"{[tuple(h.shape) for h in hidden]}, max_abs_err vs plain {rms_err:.3e}")
    del hidden

    t0 = time.perf_counter()
    phase_consistency(api, masters, params, ref)
    log(f"phase consistency: {time.perf_counter() - t0:.1f} s")

    server = serve_out["server"]
    replays = {}
    for name in CLASSES:
        engine, batch, steps = server.functions[name]
        replays[f"serve {name}"] = (lambda e=engine, b=batch, n=steps: e.generate(b, n), stats[name]["first_s"])
    phase_trace(replays, {"decode_kernel": da.decode_attention})

    # Model families: the int8 cache on internlm2's weights first, then
    # those weights are freed for the larger models.
    t0 = time.perf_counter()
    int8 = phase_int8(api, params, counter, ref)
    log(f"phase int8 cache: {time.perf_counter() - t0:.1f} s")
    del api, masters, params, serve_out, server, replays, engine, batch
    torch.cuda.empty_cache()
    fam = phase_families(ref, counter)
    fam["int8"] = int8
    check_families(fam, layers)

    def new_rows(kernel, keys):
        return [dict(shape=json.loads(json.dumps(k)), **{f: arows[(kernel, k, "bfloat16")][f] for f in (
            "err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}) for k in keys]

    paths = {"dense": (flash_launches, decode_launches)}
    paths.update({key: (fam[key]["launches"]["flash"], fam[key]["launches"]["decode"])
                  for key in ("int8", "olmoe", "deepseek", "vlm", "xlstm", "launcher")})
    by_path = {k: dict(zip(("flash", "decode"), v)) for k, v in paths.items()}
    moe_decode = [k + (MOE_H, MOE_HKV) for k in DECODE_MOE]
    kernels = [
        _summary("disagg_gram", "src/repro/kernels/disagg_solve.py:84",
                 gram_launches + comb_fleet_gram + comb_ctrl_gram + elastic_gram,
                 [rows[k] for k in MAIN_SHAPES + COMBINED_GRAM_SHAPES], MAIN_SHAPES + COMBINED_GRAM_SHAPES,
                 launches_by_path={"fleet": gram_launches, "combined_fleet": comb_fleet_gram,
                                   "combined_controller": comb_ctrl_gram, "elastic": elastic_gram},
                 elastic_shapes=[dict(shape=list(k), **{f: r[f] for f in (
                     "err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "variant",
                     "warm_ms", "library_warm_ms")}) for k, r in elastic_rows.items()]),
        _summary("flash_attention", "src/repro/kernels/flash_attention.py:134",
                 sum(v["flash"] for v in by_path.values()),
                 [arows[("flash_attention", k, "bfloat16")] for k in FLASH_MAIN], FLASH_MAIN,
                 source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 launches_by_path={k: v["flash"] for k, v in by_path.items()},
                 moe_shapes=new_rows("flash_attention", FLASH_MOE), vlm_shapes=new_rows("flash_attention", FLASH_VLM)),
        _summary("decode_attention", "src/repro/kernels/decode_attention.py:119",
                 sum(v["decode"] for v in by_path.values()),
                 [arows[("decode_attention", k, "bfloat16")] for k in DECODE_MAIN], DECODE_MAIN,
                 launches_by_path={k: v["decode"] for k, v in by_path.items()},
                 moe_shapes=new_rows("decode_attention", moe_decode)),
        _summary("rmsnorm", "src/repro/kernels/rmsnorm.py:52", rms_launches,
                 [arows[("rmsnorm", k, "bfloat16")] for k in RMS_MAIN], RMS_MAIN),
    ]
    log(f"build_s {build_s:.2f} total_s {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Kernel bench (``--bench``): decode and gram on any tree, no path run
# ---------------------------------------------------------------------------


def bench_main(argv: list) -> int:
    """Time the decode-attention and gram kernels of any tree of the port.

    ``python3 chip_smoke.py --bench [DIR]`` imports ``repro_torch`` from
    ``DIR`` (default: this checkout's ``src``), so that one call can time
    two trees on one card.  Per kernel and shape it prints ``time_decode``'s
    or ``time_gram``'s row (cold and warm, the kernel's and the library
    call's), at decode's main shapes (bf16) and at the gram's main shapes,
    its parity shapes with M >= 64 and those either side of the variants'
    threshold.  For decode it adds ``len1_ms`` (every length 1: the
    launch's fixed cost at that grid) and ``host_us`` (the wrapper's host
    time per call over 1,000 calls with no synchronisation, the median of
    five rounds).  The last line is all of it as JSON.
    """
    if not torch.cuda.is_available():
        print("chip_smoke --bench: torch.cuda.is_available() is false; this needs a CUDA GPU", file=sys.stderr)
        return 2
    src = Path(argv[0] if argv else SRC).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import disagg_solve as ds

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | repro_torch from {da.__file__}", flush=True)
    ds.build()
    da.build()
    out = dict(src=str(src), device=smi, decode={}, gram={})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, smax, lengths in DECODE_MAIN:
        q = torch.randn(b, H, HD, generator=gen, device="cuda").bfloat16()
        kc, vc = (torch.randn(b, smax, HKV, HD, generator=gen, device="cuda").bfloat16() for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        row = time_decode(da, q, kc, vc, lens, warm=True)
        ones = torch.ones_like(lens)
        row["len1_ms"] = device_ms(lambda: da.decode_attention(q, kc, vc, ones))
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                da.decode_attention(q, kc, vc, lens)
            rounds.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        row["host_us"] = statistics.median(rounds)
        row["host_us_rounds"] = rounds
        out["decode"][f"B={b} S_max={smax} len={lengths[0]}"] = row
        print(f"decode B={b} S_max={smax}: " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    rng = np.random.default_rng(0)
    for g, n, m in BENCH_GRAM:
        c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32)).cuda()
        w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).cuda()
        row = time_gram(ds, c, w, warm=True)
        out["gram"][f"{g}x{n}x{m}"] = row
        print(f"gram G={g} N={n} M={m}: " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(bench_main(sys.argv[2:]) if sys.argv[1:2] == ["--bench"] else main())
