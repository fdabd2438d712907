#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on past):

1. Device and build: requires CUDA, prints the card's name and power limit,
   switches TF32 off, builds every CUDA source of ``src/repro_torch`` at
   once (one nvcc each), prints each one's build time and ptxas report,
   and counts the tensor-core flash kernel's ``HGMMA`` and ``UTMALDG``
   instructions, the decode kernel's asynchronous loads (``LDGSTS`` or
   ``UTMALDG``) and, in each tensor-core instance of the flash backward
   (the dK/dV and dQ passes at d 64, 112 and 128), ``HGMMA`` and
   ``UTMALDG`` with no ``HMMA`` (``mma.sync``), in their SASS
   (``cuobjdump``): none, or no ``cuobjdump``, fails the run.  The flash
   forward's, the flash backward's and the decode plans' shared memory
   (and the decode tile) must be what the built kernels compute.  ptxas's
   registers and spills of the backward's tensor-core instances (0 bytes
   spilled, asserted) and of the decode kernel's d 128 instances at
   register groups 4 and 8 (the dense models' GQA groups 4, 5 and 6) are
   printed.
2. Kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at its main path's shapes and at ragged ones, in bf16 and fp32
   for the attention and RMSNorm kernels (zamba2's d 112 at H = Hkv = 32,
   seamless's non-causal encoder, cross-attention with S != T, decode
   against a full static memory, and flash and decode at GQA groups 4, 5
   and 6 (the three dense models' 32, 40 and 48 heads over 8) at d 128,
   at their classes' shapes in bf16 and ragged in both, among them); per
   shape the kernel's, the plain
   version's and one PyTorch library call's device times (cold L2), the
   kernel's and the library call's warm back-to-back time per launch, and
   the memory/compute bound.  The decode and gram kernels must give the
   same bits on a second call.  Flash in bf16 at d 64/112/128 is the
   tensor-core kernel, whose d = 112 instance's SASS must hold HGMMA and
   UTMALDG too.  bf16 attention outputs are held per row against the reference
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
   weights from a seeded generator, bf16 compute) serves 12 requests of two
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
12. Model families, at full width from seeded random weights:
   zamba2-7b (hybrid: 81 Mamba2 layers and one shared attention block at
   14 of them, d 112; served cut to 27 layers, five application points)
   and seamless-m4t-large-v2 (24 + 24 layers, source frames as many as
   the prompt's tokens; full depth), 3 requests each of the two classes,
   one summarize request traced, with their fp32 invariants, kernels against
   plain versions (zamba2's on a copy cut to 13 layers: its fp32 masters
   do not fit beside the served bf16 weights) and one decode step under
   the sync gate; the int8
   KV cache on the served internlm2 weights (the reference's pins: decode
   logits against the bf16 cache's, cosine > 0.999 and argmax equal;
   greedy tokens against it; cache bytes; 3 chat requests served, no
   decode kernel launched: the reference runs int8 decode as plain code);
   olmoe-1b-7b at full depth serving 3 requests of the two classes
   (a summarize request traced: device busy per request), its fp32 invariants, kernels
   against plain versions and the share of routing choices bf16 and fp32
   make alike; deepseek-moe-16b cut to 4 layers (dense layer 0 + 3 MoE
   layers with shared experts), one prefill and 16 decode steps;
   xlstm-350m, 3 chat requests; internvl2-2b, 3 requests of 256 patch
   embeddings + 256 tokens; the fp32 prefill/decode invariants of each;
   one decode step of olmoe, xlstm and the int8 cache under
   ``torch.cuda.set_sync_debug_mode("error")``; granite-3-8b,
   nemotron-4-15b and qwen2.5-14b at full width and depth from bf16
   weights alone (qwen's QKV biases drawn non-zero), 3 requests each of the
   two classes, their fp32 invariants and kernels against plain versions
   on a copy cut to 4 layers, one decode step each under the sync gate;
   then ``repro_torch.launch.serve``'s defaults (the reference's mix, reduced)
   and ``--archs zamba2-7b,seamless-m4t-large-v2``.  Each path's flash and
   decode launches must be one per attention layer (zamba2: per
   application point; seamless: encoder, decoder self- and
   cross-attention) per prefill and per decode step.
13. Training, after the families' weights are freed: (a) the flash VJP at
   bf16 d 64/112/128 (the tensor-core kernels) and fp32 (the FMA kernels),
   causal and not, S = T and S < T, and at phase 16's ranks' training
   calls (internlm2's and zamba2's heads a rank, zamba2's in fp32 too): the
   hand forward's out and lse against
   the plain ``flash_fwd``, the backward kernels' dq, dk, dv against the
   plain ``flash_bwd`` on the same inputs, and dq, dk, dv through
   ``ops.flash_attention``'s autograd Function (the hand forward, then the
   hand backward, one launch each) against autograd through a dense fp32
   attention, with the forward timed with and without its lse store, the
   backward kernels (cold, and warm at the training shape), ``flash_bwd``,
   and SDPA's forward and backward; (b) internlm2-1.8b cut to 2 layers at
   full width, fp32: one ``make_train_step`` on the card and on the CPU (loss,
   gradients) and the AdamW update from the same gradients; (c)
   internlm2-1.8b at full width and depth through
   ``repro_torch.launch.train.main`` (12 steps, batch 4 x 2048, bf16
   compute, fp32 masters, remat "full"): straight through, then with
   checkpoints every 8 steps, killed right after step 8's checkpoint, and
   relaunched: it resumes at 8 and must repeat the straight run's steps
   8-11 and final parameters bitwise (the step is deterministic on the
   card); two 21.19 GiB states written in all, under the machine's
   45 GiB of disk writes a call; finite and falling losses; exactly 2 x
   24 flash launches a step, all tensor-core, and 24 of the backward; one
   warm step traced on the straight run's final state (busy, idle share,
   the flash forward kernels' and the backward kernels' shares, read by
   kernel name), step time, tokens/s, 6ND against 989 TFLOP/s,
   peak memory; the relaunch's final state is kept for phase 14 (e).
   The launcher places the state on the local mesh (1, 1) ("data",
   "model") under ``TRAIN_RULES``; on one device every leaf stays a plain
   tensor (checked).
14. Distributed, on a one-rank NCCL group made in this process (a
   ``TCPStore`` on a free port; the group is destroyed at the phase's end)
   and the local mesh (1, 1): (b) olmoe-1b-7b's MoE block at full width on
   tokens 8 x 512 through ``moe_apply``'s EP path (``use_rules``) against
   the capacity path, outputs, aux and the gradients of x and the expert
   weights, fp32 (1e-5 of scale, bitwise printed) and bf16 (2e-2), both
   timed; (c) the int8 and exact all-to-alls at (64, cap, 2048) bf16,
   bitwise against their plain versions, µs and device operations per
   call; (f) ``--mesh pod`` raising with the 256 ranks it needs; (e) the
   training phase's last checkpoint restored with ``state_shardings`` on
   the local mesh, bitwise against the unplaced state it was written from
   (the relaunch's final state; the checkpoint is read once); (d)
   ``compressed_pod_mean`` on a one-rank "pod" mesh over the restored
   1.896e9-element parameter tree, each leaf within amax/127 + 1e-6; (g)
   ``launch.costs.step_cost`` of the training cell beside its measured
   step.  No hand kernel runs here (every count stays 0).
15. Dry run (``launch.dryrun``): (a) the training cell (internlm2-1.8b,
   4 x 2048, remat "full", bf16 on fp32 masters) traced on fake CUDA
   tensors on the (1, 1) mesh of a one-rank fake world, then one real step
   of it on a fresh state under ``FlopCounterMode``: the trace's
   ``flash_attention_lse`` ops must equal the real step's flash launches
   (48) and its ``flash_attention_bwd`` ops the real step's backward
   launches (24), its FLOPs the real step's exactly, and its
   ``peak_bytes_est`` the real step's ``max_memory_allocated`` above what was allocated before,
   within 15 %; (b) internlm2-1.8b train_4k, olmoe-1b-7b train_4k under the
   EP rules, internlm2-1.8b prefill_32k and decode_32k, and zamba2-7b
   train_4k and prefill_32k (each ``peak_bytes_est`` within a card's 79.18
   GiB, its Mamba2 blocks split over "model") on the (16, 16) pod of a
   fake 256-rank world, each with its custom ops counted and its roofline
   row printed; (c) host µs per call of the decode and flash
   kernels through the wrapper, the ``repro_torch::`` custom op and
   ``ops``.  No fake trace may launch a kernel, build a library or hand a
   CUDA tensor to a plain version.  The kernel parity of phase 2 and the
   flash VJP of phase 13 call the kernels through their custom ops.
16. Tensor parallelism over "model" (``distributed.tensor_parallel``):
   two rank processes share the one card over a gloo group on CUDA tensors
   (NCCL refuses two ranks on one GPU), on the mesh ("data", "model") =
   (1, 2), for each of ``TP_ARCHS``: internlm2-1.8b at full width and
   depth, then zamba2-7b at full width, trained cut to 12 of its 81 layers
   and served cut to 27 (the families phase's depth), its Mamba2 blocks on
   the ranks' 56 of 112 heads.  Rank 0 first runs the one-process program alone and frees it:
   bf16 on fp32 masters, remat "full", ``TP_STEPS`` steps of ``TP_BATCH``
   x ``TP_SEQ`` (cut from 4 x 2048: every collective of the split program
   goes through the host in gloo), then a prefill and ``TP_DECODE`` decode
   steps of bf16 weights.  Then both ranks run the split program on the
   same seeded weights and batches under ``TRAIN_RULES`` and
   ``SERVE_RULES``: the losses, the gathered parameters and first moments
   after the steps, the prefill's and decode steps' logits, against rank
   0's, at ``TP_TOL``'s bounds (zamba2's first moments and logits from a
   step and a serve in fp32 cut to 4 layers, ``TP_FP32_CHECKS``);
   tensor-core flash, forward and backward, at the ranks' heads (d 128
   and 112), decode on the ranks' kv heads.  Phase 15 (b)'s worker
   processes trace beside it.
   Then in this process the kv_seq merge alone: a 32,768-row cache cut
   into 16 blocks (internlm2 decode_32k's block on the pod), each through
   the ``decode_attention_lse`` op at its clipped lengths, merged by
   ``models.attention.merge_partials``, against the unsplit kernel.
17. Examples: the five twins in ``examples_torch/`` on the card
   (``quickstart``, ``stream_energy``, ``capped_cluster`` and
   ``train_energy`` in this process, ``serve_energy`` as its own).

Each path's kernel launch counts are zeroed just before it and read just
after (every bf16 flash launch of the serving paths must be a tensor-core
one); while the fleet, streaming, combined, control, elastic and serving
paths run, the plain versions are watched, and a CUDA tensor reaching one
fails the run (the launches that compare a kernel with its plain version
are outside those paths); ``flash_fwd`` and ``flash_bwd``, the plain
forward and backward of the training path, are watched too.

Output: one line per measurement, a ``combined_control {...}`` JSON line of
phases 5-6, an ``elastic {...}`` one of phase 7, a ``families {...}``
one of phase 12, a ``training {...}`` one of phase 13, a
``distributed {...}`` one of phase 14, a ``dryrun {...}`` one of phase
15 and a ``tensor_parallel {...}`` one of phase 16, then a
``{"kernels": [...]}`` JSON line,
the ``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; no network.

``python3 chip_smoke.py --bench [DIR]`` runs only the flash, decode and gram
kernel timings (``bench_main``), of this tree or another one.
``python3 chip_smoke.py --tp-rank RANK WORLD DIR DEVICE SIZE ARCHS`` is one
rank of phase 16, which starts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import json
import math
import os
import re
import shutil
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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
SCHEDULE = [f"{ARCH}/chat", f"{ARCH}/chat", f"{ARCH}/summarize"] * 4  # 12 requests, 2:1
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
# olmoe-1b-7b at full depth in internlm2's two classes (3 requests, 2:1);
# deepseek-moe-16b cut from 28 layers to 4 (dense layer 0 + 3 MoE layers:
# its 16.9 B parameters would take 34 GB in bf16 besides the fp32 masters);
# xlstm-350m in the chat class only (its sLSTM is a loop over time, so a
# 4,096-token summarize prompt is 49,152 sequential steps); internvl2-2b
# with 256 patch embeddings + 256 tokens; the int8 cache on internlm2-1.8b.
OLMOE = "olmoe-1b-7b"
OLMOE_CLASSES = {f"{OLMOE}/chat": CLASSES[f"{ARCH}/chat"], f"{OLMOE}/summarize": CLASSES[f"{ARCH}/summarize"]}
OLMOE_SCHEDULE = [f"{OLMOE}/chat", f"{OLMOE}/chat", f"{OLMOE}/summarize"]  # 3 requests, 2:1
DEEPSEEK, DEEPSEEK_LAYERS = "deepseek-moe-16b", 4
DEEPSEEK_CLASS = dict(batch=8, prompt=512, steps=17)  # one prefill + 16 decode steps
XLSTM = "xlstm-350m"
XLSTM_CLASSES = {f"{XLSTM}/chat": CLASSES[f"{ARCH}/chat"]}
XLSTM_SCHEDULE = [f"{XLSTM}/chat"] * 3
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

# The hybrid and encoder-decoder families, full width, random weights from a
# seeded generator, in internlm2's two classes (3 requests each, 2:1).
# zamba2-7b (81 Mamba2 layers, one shared attention block applied at 14 of
# them, 32 heads of 112): 10.85 B parameters, 21.7 GB in bf16 beside 43.4 GB
# of fp32 masters, at full depth.  seamless-m4t-large-v2 (24 + 24 layers, 16
# heads of 64): the source is as many frame embeddings as the target prompt
# has tokens (the reference's prefill_inputs).  zamba2 serves from its bf16
# weights alone: beside the 43.4 GB of fp32 masters, its summarize warmup
# ran out of the card's 79.18 GiB (75.24 GiB allocated, 60.8 of them
# weights).  Its fp32 invariants and kernels-against-plain run on a copy cut
# to 13 layers (application points 0, 6 and 12), full width.
ZAMBA = "zamba2-7b"
ZAMBA_CHECK_LAYERS = 13
# The families phase and phase 16 serve zamba2-7b cut to 27 of its 81 layers
# (five shared-attention points), for the run's time limit.
ZAMBA_SERVE_LAYERS = 27
ZAMBA_CLASSES = {f"{ZAMBA}/chat": CLASSES[f"{ARCH}/chat"], f"{ZAMBA}/summarize": CLASSES[f"{ARCH}/summarize"]}
ZAMBA_SCHEDULE = [f"{ZAMBA}/chat", f"{ZAMBA}/chat", f"{ZAMBA}/summarize"]
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_CLASSES = {f"{SEAMLESS}/chat": CLASSES[f"{ARCH}/chat"],
                    f"{SEAMLESS}/summarize": CLASSES[f"{ARCH}/summarize"]}
SEAMLESS_SCHEDULE = [f"{SEAMLESS}/chat", f"{SEAMLESS}/chat", f"{SEAMLESS}/summarize"]
# Attention shapes those paths add.  zamba2's shared block: H = Hkv = 32 at
# d 112 (the tensor-core kernel on two 64-column panels), at the classes'
# shapes and ragged ones (S, T not tile multiples, S < T, not causal).
# seamless at d 64, H = Hkv = 16: the encoder (non-causal) and decoder
# self-attention at the classes' shapes, and cross-attention with S != T.
ZAMBA_H = ZAMBA_HKV = 32
ZAMBA_HD = 112
FLASH_ZAMBA = [(8, 512, 512, 32, 32, 112, True), (2, 4096, 4096, 32, 32, 112, True)]
FLASH_ZAMBA_RAGGED = [(1, 100, 333, 32, 32, 112, True), (2, 77, 77, 32, 32, 112, True),
                      (1, 130, 200, 32, 32, 112, False), (1, 300, 200, 8, 8, 112, True)]
FLASH_SEAMLESS = [(8, 512, 512, 16, 16, 64, False), (2, 4096, 4096, 16, 16, 64, False),
                  (8, 512, 512, 16, 16, 64, True), (2, 4096, 4096, 16, 16, 64, True)]
FLASH_CROSS = [(8, 64, 512, 16, 16, 64, False), (2, 512, 4096, 16, 16, 64, False)]
# Decode (B, S_max, lengths, H, Hkv, d): zamba2 at each class's last step and
# ragged lengths; seamless's self-attention cache, and its cross-attention
# against the full static memory (every length = the source's frames).
DECODE_ZAMBA = [(8, 576, (575,) * 8, 32, 32, 112), (2, 4112, (4111,) * 2, 32, 32, 112)]
DECODE_ZAMBA_RAGGED = [(8, 576, (575, 1, 64, 65, 300, 2, 576, 129), 32, 32, 112),
                       (3, 1000, (1, 999, 500), 32, 32, 112)]
DECODE_SEAMLESS = [(8, 576, (575,) * 8, 16, 16, 64), (2, 4112, (4111,) * 2, 16, 16, 64)]
DECODE_STATIC = [(8, 512, (512,) * 8, 16, 16, 64), (2, 4096, (4096,) * 2, 16, 16, 64)]
# The last three dense architectures, full width and depth, from bf16 weights
# alone (16.8, 31.3 and 29.6 GB; fp32 masters beside the larger two would
# not fit), in internlm2's two classes (3 requests each, 2:1); their fp32
# invariants and kernels-against-plain run on a copy cut to
# DENSE_CHECK_LAYERS layers, full width.  Each is H heads over Hkv 8 at
# d 128: GQA groups 4 (granite), 5 (qwen2.5) and 6 (nemotron), so decode's
# register group (``head_chunks``) is 4, 8 and 8, the last two with 3 and 2
# dead heads.  qwen2.5's QKV biases are drawn 0.05 * N(0, 1) (their init
# law is zeros), so that the bias path adds something.
GRANITE, NEMOTRON, QWEN = "granite-3-8b", "nemotron-4-15b", "qwen2.5-14b"
DENSE_ARCHS = {GRANITE: 32, QWEN: 40, NEMOTRON: 48}  # arch -> H (Hkv 8, d 128)
DENSE_CHECK_LAYERS = 4
DENSE_BIAS_STD = 0.05
FLASH_DENSE = [(b, s, s, h, 8, HD, True) for h in DENSE_ARCHS.values() for b, s in ((8, 512), (2, 4096))]
# Ragged at groups 5 and 6: S and T not tile multiples, S < T, S > T, not causal.
FLASH_DENSE_RAGGED = [(1, 100, 333, 40, 8, HD, True), (2, 77, 77, 48, 8, HD, True),
                      (1, 130, 200, 40, 8, HD, False), (1, 300, 200, 48, 8, HD, True)]
# Phase 2's flash parity shapes that run in fp32 as well as bf16 (fp32 takes
# the FMA kernel at every d; bf16 adds FLASH_TP and FLASH_DENSE).
FLASH_FP32 = (FLASH_MAIN + FLASH_MOE + FLASH_VLM + FLASH_RAGGED + FLASH_ZAMBA + FLASH_ZAMBA_RAGGED + FLASH_SEAMLESS
              + FLASH_CROSS + FLASH_DENSE_RAGGED)
DECODE_DENSE = [(b, smax, (smax - 1,) * b, h, 8, HD) for h in DENSE_ARCHS.values()
                for b, smax in ((8, 576), (2, 4112))]
# Ragged decode at groups 5 and 6: lengths 1 and a full cache (S_max).
DECODE_DENSE_RAGGED = [(8, 576, (575, 1, 64, 65, 300, 2, 576, 129), 40, 8, HD),
                       (3, 1000, (1, 999, 1000), 48, 8, HD), (2, 4112, (1, 4112), 48, 8, HD)]
# Training (phase 13): internlm2-1.8b at full width and depth through
# ``python -m repro_torch.launch.train`` (bf16 compute, fp32 masters, the
# config's remat "full"), a crash after step 8's checkpoint, and a relaunch.
TRAIN_STEPS, TRAIN_CRASH = 12, 8
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_ARGS = ["--arch", ARCH, "--steps", str(TRAIN_STEPS)]
# The same step before the launcher placed its state (no mesh), on an H100
# 80GB HBM3 at 700 W (PERF.md §5): printed beside this run's.
TRAIN_STEP_UNPLACED_S = (0.7525, 0.7564)
FLASH_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, HKV, HD, True)  # every attention layer's flash call in a step
# The flash VJP's parity cases (B, S, T, H, Hkv, d, causal, dtype): bf16 at d
# 64/112/128 (the tensor-core forward) and fp32 (the FMA forward), causal and
# not, S = T and S < T (a training row always has a live key).
VJP_CASES = [FLASH_TRAIN + (torch.bfloat16,), (2, 512, 512, H, HKV, HD, False, torch.bfloat16),
             (2, 256, 768, H, HKV, HD, True, torch.bfloat16), (2, 512, 512, 16, 16, 64, True, torch.bfloat16),
             (2, 256, 640, 8, 4, 64, False, torch.bfloat16), (2, 512, 512, 32, 32, 112, True, torch.bfloat16),
             (1, 200, 456, 8, 8, 112, True, torch.bfloat16), (2, 512, 512, H, HKV, HD, True, torch.float32),
             (2, 256, 768, 8, 4, 64, False, torch.float32), (1, 300, 300, 8, 2, 112, True, torch.float32),
             (1, 100, 333, 4, 4, 32, True, torch.float32)]
# The 2-layer full-width train step held against the CPU (fp32 compute).
STEP_PARITY_LAYERS, STEP_PARITY_SHAPE = 2, (2, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def idle_power() -> dict:
    """The card's power draw at rest (the median of 10 ``nvidia-smi``
    samples 0.2 s apart, before any work) and its power limit, in W: the
    source of ``launch.mesh``'s ``CHIP_IDLE_W`` (the idle draw) and
    ``CHIP_DYN_W`` (the limit less the idle draw)."""
    draws, limit = [], float("nan")
    for _ in range(10):
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.draw,power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        draw, limit = (float(v) for v in out.strip().splitlines()[0].split(","))
        draws.append(draw)
        time.sleep(0.2)
    idle = statistics.median(draws)
    return dict(idle_w=idle, limit_w=limit, dyn_w=limit - idle, samples=draws)


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


@functools.lru_cache(maxsize=None)
def _sass(lib: Path) -> str:
    """``lib``'s SASS, disassembled once per library and run."""
    return subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout


def _sass_count(lib: Path, ops, function: str = "") -> dict:
    """Counts of each SASS opcode in ``lib``, or only in its functions whose
    (mangled) name holds ``function``."""
    sass = _sass(lib)
    if function:
        parts = [f for f in sass.split("Function : ")[1:] if function in f.split("\n", 1)[0]]
        assert parts, f"no function {function!r} in {lib.name}'s SASS"
        sass = "".join(parts)
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


def ptxas_functions(nvcc_log: str) -> dict:
    """Each compiled entry function in ``-Xptxas -v`` output -> its
    registers, stack frame and spill stores and loads (bytes)."""
    out: dict = {}
    name = None
    for line in nvcc_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


#: The flash backward's two tensor-core passes (dK/dV, dQ), each built at
#: d 64, 112 and 128: ``flash_bwd_kv_kernel<D>`` and ``flash_bwd_q_kernel<D>``.
BWD_TC_KERNELS = ("flash_bwd_kv_kernel", "flash_bwd_q_kernel")
#: The decode kernel's d 128 instances at register groups 4 and 8 (the dense
#: models' GQA groups 4, 5 and 6): ``decode_kernel<T, 128, GC>``'s mangled names.
DECODE_GROUP_INSTANCES = {f"{t} GC={gc}": f"decode_kernelI{m}Li128ELi{gc}E"
                          for t, m in (("bf16", "13__nv_bfloat16"), ("fp32", "f")) for gc in (4, 8)}


def phase_build() -> float:
    """Compile every kernel at once (one nvcc each, each timed), load each,
    check that the tensor-core flash kernel's SASS holds wgmma (HGMMA) and
    TMA loads (UTMALDG), that each tensor-core instance of the flash
    backward (both passes at d 64, 112, 128) holds HGMMA and UTMALDG and no
    ``mma.sync`` (HMMA), with 0 bytes spilled, and the decode kernel's
    asynchronous copies (LDGSTS or UTMALDG), that the plans' geometry
    (shared memory included) is the kernels', and log the registers and
    spills of the backward's instances and of the decode kernel's d 128
    group-4 and group-8 instances."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention, disagg_solve, flash_attention, rmsnorm

    t0 = time.perf_counter()
    built = kbuild.compile_all(list(KERNELS))
    for mod in (disagg_solve, flash_attention, decode_attention, rmsnorm):
        mod.build()
    flash_attention.build_bwd()
    dt = time.perf_counter() - t0
    for name in KERNELS:
        nvcc_log, secs = built[name]
        log(f"  nvcc {name}.cu: {secs:.2f} s")
        for line in nvcc_log.strip().splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line or "spill" in line) \
                    or "bytes stack frame" in line or "warning" in line:
                log(f"  nvcc {name}: {line.strip()}")
    log(f"build: {', '.join(f'{k}.cu' for k in KERNELS)} -> sm_90a in {dt:.2f} s (parallel)")
    decode_fns = ptxas_functions(built["decode_attention"][0])  # empty when built before this run
    if decode_fns:
        for label, pattern in DECODE_GROUP_INSTANCES.items():
            found = {k: v for k, v in decode_fns.items() if pattern in k}
            assert found, f"ptxas reported no {pattern} (decode {label}, d 128)"
            for fn, props in found.items():
                log(f"ptxas decode_attention d=128 {label}: {props} ({fn})")
    counts = _sass_count(kbuild.library_path("flash_attention_tc"), ("HGMMA", "UTMALDG"))
    log(f"sass flash_attention_tc: {counts}")
    assert all(counts.values()), f"the tensor-core flash kernel's SASS lacks wgmma or TMA loads: {counts}"
    counts = _sass_count(kbuild.library_path("flash_attention_tc"), ("HGMMA", "UTMALDG"), "flash_tc_kernelILi112E")
    log(f"sass flash_attention_tc d=112 instance: {counts}")
    assert all(counts.values()), f"the d = 112 tensor-core instance lacks wgmma or TMA loads: {counts}"
    bwd_fns = ptxas_functions(built["flash_attention_bwd"][0])  # empty when built before this run
    for d in flash_attention.TC_HEAD_DIMS:
        for kernel in BWD_TC_KERNELS:
            counts = _sass_count(kbuild.library_path("flash_attention_bwd"), ("HGMMA", "UTMALDG", "HMMA"),
                                 f"{kernel}ILi{d}E")
            log(f"sass flash_attention_bwd {kernel} d={d}: {counts}")
            assert counts["HGMMA"] and counts["UTMALDG"] and not counts["HMMA"], \
                f"the backward's {kernel} at d = {d} is not on wgmma fed by TMA alone: {counts}"
            if bwd_fns:
                props = [v for k, v in bwd_fns.items() if f"{kernel}ILi{d}E" in k]
                assert len(props) == 1, (kernel, d, props)
                log(f"ptxas flash_attention_bwd {kernel} d={d}: {props[0]}")
                assert props[0]["spill_stores"] == props[0]["spill_loads"] == 0, (kernel, d, props[0])
        plan = flash_attention.bwd_plan(*FLASH_TRAIN[:5], d)
        built_smem = flash_attention.bwd_smem_bytes(d)
        assert built_smem == (plan["kv"]["smem_bytes"], plan["q"]["smem_bytes"]), (d, built_smem, plan)
    log(f"flash bwd plan at the training shape (d {HD}): dK/dV grid {plan['kv']['grid']}, {plan['kv']['smem_bytes']} B, "
        f"{sum(plan['kv']['tiles'])} query tiles per (batch, KV head); dQ grid {plan['q']['grid']}, "
        f"{plan['q']['smem_bytes']} B, {sum(plan['q']['tiles'])} key tiles per (batch, head)")
    counts = _sass_count(kbuild.library_path("decode_attention"), ("LDGSTS", "UTMALDG"))
    log(f"sass decode_attention: {counts}")
    assert any(counts.values()), f"the decode kernel's SASS has no asynchronous loads: {counts}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [(b, smax, H, HKV, HD) for b, smax, _ in DECODE_MAIN]
    plans += [(b, smax, h, hkv, d) for b, smax, _, h, hkv, d in DECODE_ZAMBA]
    for b, smax, h, hkv, d in plans:
        for dtype in (torch.bfloat16, torch.float32):
            elem = _elem(dtype)
            dplan = decode_attention.decode_plan(b, h, hkv, smax, d, elem, sms)
            built = decode_attention.kernel_geometry(d, elem, dplan["group"])
            assert built == (dplan["tile"], dplan["smem_bytes"]), (b, smax, dtype, built, dplan)
            log(f"decode plan {str(dtype)[6:]} B={b} S_max={smax} H={h} Hkv={hkv} d={d}: grid {dplan['grid']} in clusters of "
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
    gram, rhs = torch.ops.repro_torch.disagg_gram(c, w)  # the custom op: the kernel's launch on the card
    gram2, rhs2 = torch.ops.repro_torch.disagg_gram(c, w)
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
        # bf16 adds the split program's and the three dense models' serving shapes
        flash_cases = FLASH_FP32 + (FLASH_TP + FLASH_DENSE if dtype == torch.bfloat16 else [])
        for b, s, t, h, hkv, d, causal in flash_cases:
            q, k, v = rnd(b, s, h, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype)
            got = torch.ops.repro_torch.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, causal)
            bf16 = dtype == torch.bfloat16
            err = _check(got, want, tol, "flash_attention", rows=bf16)
            more = dict(variant=fa.variant(dtype, d))
            if bf16:
                more["err_rms"] = _row_err(got, want)
            key = (b, s, t, h, hkv, d, causal)
            if bf16 and key in FLASH_MAIN + FLASH_MOE + FLASH_VLM + FLASH_ZAMBA + FLASH_DENSE:
                more["planted_err_rms"] = _planted_tile_fault(ref, q, k, v, want, tol)
            reps = 5 if s * t > 2**22 else 25
            t_kernel = device_ms(lambda: torch.ops.repro_torch.flash_attention(q, k, v, causal), reps)
            t_plain = device_ms(lambda: ref.flash_attention(q, k, v, causal), reps)
            t_lib = None
            if s == t or not causal:  # SDPA's causal mask is not offset by T - S
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                sdpa = lambda *a: F.scaled_dot_product_attention(*a, is_causal=causal, enable_gqa=True)
                t_lib = device_ms(lambda: sdpa(qt, kt, vt), reps)
                if key in FLASH_DENSE:  # back-to-back over copies past the L2, as in a serving loop
                    nbytes = flash_work(*key, dtype)[0]
                    more["warm_ms"] = warm_ms(lambda *a: torch.ops.repro_torch.flash_attention(*a, causal), (q, k, v),
                                              nbytes)
                    more["library_warm_ms"] = warm_ms(sdpa, (qt, kt, vt), nbytes)
            _record(rows, ("flash_attention", (b, s, t, h, hkv, d, causal), tag), err, tol, t_kernel, t_plain,
                    t_lib, flash_work(b, s, t, h, hkv, d, causal, dtype), dtype,
                    f"flash {tag} B={b} S={s} T={t} H={h} Hkv={hkv} d={d} causal={causal}", **more)
        decode_cases = [((b, smax, lengths), H, HKV, HD) for b, smax, lengths in DECODE_MAIN + DECODE_RAGGED]
        decode_cases += [((b, smax, lengths, MOE_H, MOE_HKV), MOE_H, MOE_HKV, HD) for b, smax, lengths in DECODE_MOE]
        decode_cases += [(key, *key[3:]) for key in DECODE_ZAMBA + DECODE_ZAMBA_RAGGED + DECODE_SEAMLESS
                         + DECODE_STATIC + DECODE_DENSE_RAGGED
                         + (DECODE_TP + DECODE_DENSE if dtype == torch.bfloat16 else [])]
        warm_keys = DECODE_ZAMBA + DECODE_SEAMLESS + DECODE_STATIC + DECODE_DENSE  # and the main and MoE ones
        for key, h, hkv, d in decode_cases:
            b, smax, lengths = key[:3]
            q = rnd(b, h, d, dtype=dtype)
            kc, vc = rnd(b, smax, hkv, d, dtype=dtype), rnd(b, smax, hkv, d, dtype=dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got = torch.ops.repro_torch.decode_attention(q, kc, vc, lens)
            again = torch.ops.repro_torch.decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"decode_attention not deterministic at {key}"
            want = ref.decode_attention(q, kc, vc, lens)
            err = _check(got, want, tol, "decode_attention", rows=dtype == torch.bfloat16)
            more = dict(err_rms=_row_err(got, want)) if dtype == torch.bfloat16 else {}
            timed = time_decode(da, q, kc, vc, lens, warm=key[:3] in DECODE_MAIN + DECODE_MOE or key in warm_keys)
            t_kernel, t_lib = timed.pop("ms"), timed.pop("library_ms")
            more.update(timed)
            t_plain = device_ms(lambda: ref.decode_attention(q, kc, vc, lens))
            _record(rows, ("decode_attention", key, tag), err, tol, t_kernel, t_plain, t_lib,
                    decode_work(b, h, hkv, d, lengths, dtype), dtype,
                    f"decode {tag} B={b} S_max={smax} H={h} Hkv={hkv} d={d} lengths={list(lengths)}", **more)
        for key in DECODE_LSE:  # the lse store: out the same bits, lse against the plain version's
            b, smax, lengths, h, hkv, d = key
            q = rnd(b, h, d, dtype=dtype)
            kc, vc = rnd(b, smax, hkv, d, dtype=dtype), rnd(b, smax, hkv, d, dtype=dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got, lse = torch.ops.repro_torch.decode_attention_lse(q, kc, vc, lens)
            plain_out = torch.ops.repro_torch.decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            assert torch.equal(got, plain_out), f"the lse store changed decode's output at {key}"
            want_out, want_lse = ref.decode_attention(q, kc, vc, lens, return_lse=True)
            live = lens > 0
            assert bool(torch.isneginf(lse[~live]).all()) and bool(torch.isfinite(lse[live]).all()), key
            err = float((lse[live] - want_lse[live]).abs().max())
            lse_tol = 1e-5 * max(1.0, float(want_lse[live].abs().max()))
            assert err <= lse_tol, f"decode lse at {key}: {err:.3e} > {lse_tol:.3e}"
            sdpa, args = _sdpa_with_lengths(q, kc, vc, lens)
            more = dict(out_err=float((got[live].float() - want_out[live].float()).abs().max()),
                        no_lse_ms=device_ms(lambda: torch.ops.repro_torch.decode_attention(q, kc, vc, lens)))
            nbytes = decode_work(b, h, hkv, d, lengths, dtype)[0] + 4 * b * h
            more["warm_ms"] = warm_ms(lambda *a: torch.ops.repro_torch.decode_attention_lse(*a), (q, kc, vc, lens),
                                      nbytes)
            more["library_warm_ms"] = warm_ms(sdpa, args, nbytes)
            t_kernel = device_ms(lambda: torch.ops.repro_torch.decode_attention_lse(q, kc, vc, lens))
            t_plain = device_ms(lambda: ref.decode_attention(q, kc, vc, lens, return_lse=True))
            t_lib = device_ms(lambda: sdpa(*args))
            work = decode_work(b, h, hkv, d, lengths, dtype)
            _record(rows, ("decode_attention_lse", key, tag), err, lse_tol, t_kernel, t_plain, t_lib,
                    (work[0] + 4 * b * h, work[1]), dtype,
                    f"decode+lse {tag} B={b} S_max={smax} H={h} Hkv={hkv} d={d} lengths={list(lengths)}", **more)
        for n, d in RMS_MAIN + RMS_RAGGED:
            x, g = rnd(n, d, dtype=dtype), rnd(d, dtype=torch.float32)
            got = torch.ops.repro_torch.rmsnorm(x, g, 1e-5)
            torch.cuda.synchronize()
            tol_rms = 1e-5 if dtype == torch.float32 else 2e-2  # the reference's RMSNorm tolerances
            err = _check(got, ref.rmsnorm(x, g), tol_rms, "rmsnorm")
            g_lib = g.to(dtype)
            t_kernel = device_ms(lambda: torch.ops.repro_torch.rmsnorm(x, g, 1e-5))
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


def _draw_qkv_biases(params, device) -> None:
    """Every attention layer's ``bq``/``bk``/``bv`` drawn in place,
    ``DENSE_BIAS_STD`` * N(0, 1) in fp32 from a seeded generator (their
    init law is zeros, which would leave the bias path adding nothing)."""
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for layer in params["layers"]:
            for key in ("bq", "bk", "bv"):
                bias = layer["attn"][key]
                bias.copy_(DENSE_BIAS_STD * torch.randn(bias.shape, generator=gen, device=device))


def build_model(device="cuda", reduced=False, arch=ARCH, layers=None, masters=True):
    """``arch`` (full width unless ``reduced``; ``layers`` cuts the depth):
    fp32 masters from a seeded generator on ``device``, and the bf16
    compute copy (the leaves the reference reads in fp32 stay fp32).  With
    ``masters=False`` only the bf16 copy is kept (drawn leaf by leaf in
    fp32, as the masters are) and the masters come back None.  QKV biases
    (qwen2.5) are drawn by ``_draw_qkv_biases``, the same in both copies."""
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
    gen = torch.Generator(device=device).manual_seed(0)
    if masters:
        masters = materialize(api.params_def, gen, torch.float32)
        if cfg.qkv_bias:
            _draw_qkv_biases(masters, device)
        params = cast_params(masters, torch.bfloat16)
    else:
        masters, params = None, materialize(api.params_def, gen, torch.bfloat16)
        if cfg.qkv_bias:
            _draw_qkv_biases(params, device)
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
    """The full forward's logits over a prompt batch (patches included; an
    encoder-decoder's over its target tokens, from its source frames)."""
    from repro_torch.models.encdec import encdec_train
    from repro_torch.models.transformer import decoder_train, hybrid_train
    from repro_torch.models.xlstm import xlstm_train

    family = api.cfg.family
    if family == "ssm":
        return xlstm_train(params, batch["tokens"], api.cfg)[0]
    if family == "hybrid":
        return hybrid_train(params, batch["tokens"], api.cfg)[0]
    if family == "encdec":
        return encdec_train(params, batch["src_embeds"], batch["tokens"], api.cfg)[0]
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


def attention_launches(cfg) -> tuple[int, int]:
    """(flash, decode) launches of one prefill and of one decode step: one
    per attention layer (xLSTM none); zamba2's shared block once per
    application point; an encoder-decoder's encoder layers at prefill, and
    each decoder layer's self- and cross-attention at both."""
    from repro_torch.models.transformer import compute_dtype, n_attn_points

    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return n_attn_points(cfg), n_attn_points(cfg)
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    return cfg.num_layers, cfg.num_layers


def expected_launches(api, classes, schedule) -> tuple[int, int]:
    """(flash, decode) launches of serving ``schedule``: ``attention_launches``
    per prefill (every request and each class's cold start) and per decode
    step."""
    per_prefill, per_step = attention_launches(api.cfg)
    prefills = len(schedule) + len(classes)
    return per_prefill * prefills, per_step * sum(classes[n]["steps"] - 1 for n in schedule)


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
                 gate=False, vs_plain=False, trace=False, check_layers=None, layers=None) -> dict:
    """Build ``arch`` at full width (fp32 masters and the bf16 copy), serve
    ``schedule`` through ``MeteredServer``, meter and price it; with
    ``trace``, trace one warm summarize request (device busy per request;
    of the two classes the one of fewer decode steps, so fewer kernels for
    the profiler to record);
    check the fp32 invariants (and, with ``vs_plain``, kernels against
    plain versions); with ``gate``, one decode step under the sync gate;
    then free the weights.  ``layers`` cuts the served model's depth.  With
    ``check_layers`` the served model is bf16 alone, and the fp32 checks
    run on a copy cut to that depth (fp32 masters and its own bf16 copy),
    full width."""
    from repro_torch.launch.serve import random_batch
    from repro_torch.configs.shapes import ShapeConfig

    t0 = time.perf_counter()
    api, masters, params = build_model(device, reduced, arch, layers=layers, masters=check_layers is None)
    cuda = torch.device(device).type == "cuda"
    serve_out, stats, launches = serve_path(api, params, classes, schedule, counter, ref, device)
    log(f"family {arch}: built and served in {time.perf_counter() - t0:.1f} s")
    out = dict(arch=api.cfg.name, layers=api.cfg.num_layers, stats=stats, launches=launches, eff=serve_out["eff"],
               peak_gb=serve_out["peak_gb"], expected=expected_launches(api, classes, schedule),
               params=sum(p.numel() for p in params.parameters()))
    if cuda and trace:
        name = next(n for n in classes if n.endswith("/summarize"))
        engine, batch, steps = serve_out["server"].functions[name]
        phase_trace({f"serve {name}": (lambda: engine.generate(batch, steps), stats[name]["first_s"])})
        log(f"family {arch}: traced at {time.perf_counter() - t0:.1f} s")
    check = (api, masters, params)
    if check_layers is not None:
        check = build_model(device, reduced, arch, layers=check_layers)
        out["check_layers"] = check_layers
    out["fp32"] = check_fp32(*check[:2], device)
    if vs_plain:
        out.update(kernels_vs_plain(*check, ref, device))
        log(f"family {arch}: kernels against plain versions done at {time.perf_counter() - t0:.1f} s")
    del check
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
    reference's mix, reduced configs) on ``device``, then with ``--archs
    zamba2-7b,seamless-m4t-large-v2``: every architecture served and
    metered, none skipped."""
    import io

    from repro_torch.launch import serve

    runs = ((["--requests", "6"], ("internlm2-1.8b", "xlstm-350m", "olmoe-1b-7b")),
            (["--requests", "4", "--archs", f"{ZAMBA},{SEAMLESS}"], (ZAMBA, SEAMLESS)))
    texts = []
    for argv, names in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), main_path(ref):
            serve.main([*argv, "--device", device])
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"launcher | {line}")
        assert "skipped" not in text
        for name in names:
            assert f"{name}/generate registered" in text, name
            assert any(f"{name}/generate " in ln and "usd/inv=" in ln for ln in text.splitlines()), name
        texts.append(text)
    return "".join(texts)


def phase_examples(ref, counter, device="cuda") -> dict:
    """The five example twins (``examples_torch/``) on ``device``: the
    metering ones and ``train_energy`` (its checkpoints in a fresh temporary
    directory, so it trains all 60 steps) in this process (the plain
    versions watched, the hand kernels' launches counted), ``serve_energy``
    as its own process, as a user runs it.  Each must finish and print its
    figures, none of them NaN."""
    import io
    import runpy
    import tempfile

    root = Path(__file__).resolve().parent / "examples_torch"
    marks = {"quickstart": "cosine vs marginal-energy ground truth", "stream_energy": "cap stats:",
             "capped_cluster": "static 20 W buffer", "train_energy": "60 steps, final loss"}
    out: dict = {}
    for name, mark in marks.items():
        t0 = time.perf_counter()
        buf, argv, tmp_root = io.StringIO(), sys.argv, tempfile.tempdir
        sys.argv = [str(root / f"{name}.py"), "--device", device]
        counter.zero()
        try:
            with contextlib.redirect_stdout(buf), main_path(ref), tempfile.TemporaryDirectory() as tmp:
                tempfile.tempdir = tmp
                runpy.run_path(sys.argv[0], run_name="__main__")
        finally:
            sys.argv, tempfile.tempdir = argv, tmp_root
        text = buf.getvalue()
        assert mark in text and not re.search(r"\bnan\b", text.lower()), (name, text[-2000:])
        out[name] = dict(seconds=time.perf_counter() - t0, launches=counter.read())
        log(f"example {name} on {device}: {out[name]['seconds']:.1f} s, hand-kernel launches {out[name]['launches']}; "
            f"last line: {text.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, str(root / "serve_energy.py"), "--device", device],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "== serving 24 requests ==" in proc.stdout and proc.stdout.count("usd/inv=") == 3, proc.stdout[-2000:]
    out["serve_energy"] = dict(seconds=time.perf_counter() - t0)
    for line in proc.stdout.strip().splitlines()[-5:]:
        log(f"example serve_energy | {line}")
    log(f"example serve_energy on {device}: {out['serve_energy']['seconds']:.1f} s (its own process)")
    return out


class LaunchCounter:
    """Zero and read the hand kernels' launch counts (a path's counts are
    zeroed just before it and read just after)."""

    def __init__(self, fa, da, rn, ds):
        self.fns = dict(flash=fa.flash_attention, flash_bwd=fa.flash_attention_bwd, decode=da.decode_attention,
                        rmsnorm=rn.rmsnorm, gram=ds.disagg_gram)

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0
        self.fns["flash"].launches_tc = 0
        self.fns["flash_bwd"].launches_fma = 0
        self.fns["decode"].launches_lse = 0

    def read(self) -> dict:
        out = {k: fn.launches for k, fn in self.fns.items()}
        out["flash_tc"] = self.fns["flash"].launches_tc
        out["flash_bwd_fma"] = self.fns["flash_bwd"].launches_fma
        out["decode_lse"] = self.fns["decode"].launches_lse
        return out


def phase_families(ref, counter, device="cuda", reduced=False) -> dict:
    """zamba2-7b, seamless-m4t-large-v2, olmoe-1b-7b, deepseek-moe-16b
    (depth cut), xlstm-350m, internvl2-2b, granite-3-8b, nemotron-4-15b and
    qwen2.5-14b (full depth from bf16 weights alone, checked on a copy cut
    to ``DENSE_CHECK_LAYERS``), then the launcher; each path watched and
    counted on its own."""
    t0 = time.perf_counter()
    fam: dict = {}
    fam["zamba2"] = phase_family(ZAMBA, ZAMBA_CLASSES, ZAMBA_SCHEDULE, counter, ref, device, reduced,
                                 gate=True, vs_plain=True, trace=True,
                                 check_layers=None if reduced else ZAMBA_CHECK_LAYERS,
                                 layers=None if reduced else ZAMBA_SERVE_LAYERS)
    fam["seamless"] = phase_family(SEAMLESS, SEAMLESS_CLASSES, SEAMLESS_SCHEDULE, counter, ref, device, reduced,
                                   gate=True, vs_plain=True, trace=True)
    fam["olmoe"] = phase_family(OLMOE, OLMOE_CLASSES, OLMOE_SCHEDULE, counter, ref, device, reduced,
                                gate=True, vs_plain=True, trace=True)
    fam["deepseek"] = phase_deepseek(counter, ref, device, reduced)
    fam["xlstm"] = phase_family(XLSTM, XLSTM_CLASSES, XLSTM_SCHEDULE, counter, ref, device, reduced, gate=True)
    fam["vlm"] = phase_family(VLM, VLM_CLASSES, VLM_SCHEDULE, counter, ref, device, reduced)
    for key, arch in (("granite", GRANITE), ("nemotron", NEMOTRON), ("qwen", QWEN)):
        classes = {f"{arch}/chat": CLASSES[f"{ARCH}/chat"], f"{arch}/summarize": CLASSES[f"{ARCH}/summarize"]}
        fam[key] = phase_family(arch, classes, [f"{arch}/chat", f"{arch}/chat", f"{arch}/summarize"], counter, ref,
                                device, reduced, gate=True, vs_plain=True,
                                check_layers=None if reduced else DENSE_CHECK_LAYERS)
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
    for key in ("zamba2", "seamless", "olmoe", "xlstm", "vlm", "deepseek", "granite", "nemotron", "qwen"):
        got, (flash_want, decode_want) = fam[key]["launches"], fam[key]["expected"]
        assert (got["flash"], got["decode"]) == (flash_want, decode_want), (key, got, flash_want, decode_want)
        assert got["flash_tc"] == got["flash"], (key, got)
        assert fam[key].get("eff", 0.0) <= 1e-5, (key, fam[key]["eff"])
        log(f"serve launches {fam[key]['arch']}: flash_attention {got['flash']} (tensor-core {got['flash_tc']}), "
            f"decode_attention {got['decode']}")
    assert fam["launcher"]["launches"]["flash"] > 0 and fam["launcher"]["launches"]["decode"] > 0, fam["launcher"]
    log("families " + json.dumps(fam, default=str))


# ---------------------------------------------------------------------------
# Training (phase 13)
# ---------------------------------------------------------------------------


def flash_bwd_work(b, s, t, h, hkv, d, causal, dtype):
    """(bytes, flops) of the attention backward: q, k, v, out, dout and lse
    read once, dq, dk, dv written once; 5 products of 2 * d flops per live
    pair (the recomputed Q K^T, dO V^T, dS K, dS^T Q, P^T dO)."""
    nbytes, fwd_flops = flash_work(b, s, t, h, hkv, d, causal, dtype)  # q, k, v, out
    nbytes += _elem(dtype) * (2 * b * s * h * d + 2 * b * t * hkv * d) + 4 * b * h * s  # dout, dq; dk, dv; lse
    return nbytes, 2.5 * fwd_flops


# (atol of max(1, max|want|), rtol) for (fp32, bf16).  The Function
# against the dense fp32 oracle: fp32 the reference's pin; bf16 1e-2 and
# 2e-2, since the inputs are the same bf16 values on both sides and the
# Function's gradients are rounded to bf16 at the end (2^-8 relative) after
# a backward that read the kernel's bf16 output.
GRAD_TOL = ((3e-4, 1e-3), (1e-2, 2e-2))
# The backward kernels against the plain ``flash_bwd`` on the same inputs,
# at ``tests/test_torch_kernels.py``'s bounds: fp32 sums in another order;
# bf16 P and dS rounded to bf16 for the kernels' products, where the plain
# version rounds the scores.
BWD_TOL = ((1e-4, 1e-3), (2e-2, 2e-2))


def _grad_close(got, want, dtype, what, tol=GRAD_TOL) -> float:
    """Asserts |got - want| <= atol * max(1, max|want|) + rtol * |want|,
    with ``tol``'s (atol, rtol) for ``dtype``; returns the max abs error."""
    g, w = got.float(), want.float()
    scale = max(1.0, float(w.abs().max()))
    atol, rtol = tol[dtype != torch.float32]
    err = (g - w).abs()
    bad = ~(err <= atol * scale + rtol * w.abs())
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.numel()} off, max abs err {float(err.max()):.3e}"
    return float(err.max())


def _vjp_key(b, s, t, h, hkv, d, causal, dtype) -> tuple:
    return (b, s, t, h, hkv, d, causal, str(dtype).split(".")[1])


def _bwd_row(r: dict) -> dict:
    """A VJP row's backward fields under the ``kernels`` line's names."""
    return dict(err=r["err_bwd_plain"], ms=r["bwd_ms"], plain_ms=r["plain_bwd_ms"], library_ms=r["library_bwd_ms"],
                bound_ms=r["bwd_bound_ms"], bound_by=r["bwd_bound_by"], variant=r["variant"])


def phase_train_vjp(ref) -> dict:
    """The flash VJP on the card, at ``VJP_CASES`` and the tensor-parallel
    ranks' training calls (``VJP_TP``): the hand forward's out and lse
    against the plain ``flash_fwd``; the backward kernels' dq, dk, dv
    against the plain ``flash_bwd`` on the same (q, k, v, out, lse, dout)
    (at ``BWD_TOL``); and dq, dk, dv
    through ``ops.flash_attention``'s Function (the hand forward with its
    lse, then the hand backward: one launch of each) against autograd
    through the dense fp32 oracle ``ref.attention_dense`` (the reference
    pins its flash VJP to its twin).  Timed: the forward with and without
    the lse store, the backward kernels (cold L2; at the training shape
    also warm, back to back), the plain ``flash_bwd``, and SDPA's forward
    and backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows: dict = {}
    for b, s, t, h, hkv, d, causal, dtype in VJP_CASES + VJP_TP:
        key = _vjp_key(b, s, t, h, hkv, d, causal, dtype)
        q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d)))
        out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
        torch.cuda.synchronize()
        want_out, want_lse = ref.flash_fwd(q, k, v, causal)
        err_out = _check(out, want_out, _tol(dtype), "flash out with lse", rows=dtype == torch.bfloat16)
        assert torch.equal(out, torch.ops.repro_torch.flash_attention(q, k, v, causal)), \
            "the lse store changed the output"
        err_lse = float((lse - want_lse).abs().max())
        assert err_lse <= 2e-5 * max(1.0, float(want_lse.abs().max())), (key, err_lse)
        del want_out, want_lse
        kernel = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, do, causal)
        plain = ref.flash_bwd(q, k, v, out, lse, do, causal)
        err_bwd_plain = max(_grad_close(a, w, dtype, f"flash backward {n} against flash_bwd at {key}", BWD_TOL)
                            for n, a, w in zip(("dq", "dk", "dv"), kernel, plain))
        del kernel, plain
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
        got = torch.autograd.grad(ops.flash_attention(qg, kg, vg, causal=causal), (qg, kg, vg), do)
        torch.cuda.synchronize()
        launched = (fa.flash_attention.launches - before[0], fa.flash_attention_bwd.launches - before[1])
        assert launched == (1, 1), (key, launched)
        q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
        want = torch.autograd.grad(ref.attention_dense(q32, k32, v32, causal=causal), (q32, k32, v32), do.float())
        errs = {n: _grad_close(a, w, dtype, f"flash VJP {n} at {key}") / max(1.0, float(w.abs().max()))
                for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        del got, want, q32, k32, v32, qg, kg, vg
        reps = 5 if s * t > 2**22 else 15
        row = dict(err_out=err_out, err_lse=err_lse, **{f"err_{n}": e for n, e in errs.items()},
                   err_bwd_plain=err_bwd_plain, variant=fa.variant(dtype, d),
                   ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps),
                   lse_ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=causal, lse=lse), reps),
                   plain_ms=device_ms(lambda: ref.flash_fwd(q, k, v, causal), reps),
                   bwd_ms=device_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal), reps),
                   plain_bwd_ms=device_ms(lambda: ref.flash_bwd(q, k, v, out, lse, do, causal), reps),
                   library_ms=None, library_bwd_ms=None)
        bwd_bytes, bwd_flops = flash_bwd_work(b, s, t, h, hkv, d, causal, dtype)
        if (b, s, t, h, hkv, d, causal) == FLASH_TRAIN and dtype == torch.bfloat16:  # the training path's call
            row["bwd_warm_ms"] = warm_ms(lambda *a: fa.flash_attention_bwd(*a, causal=causal), (q, k, v, out, lse, do),
                                         bwd_bytes)
        if s == t or not causal:  # SDPA's causal mask is not offset by T - S
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), reps)
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
            row["library_bwd_ms"] = device_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), reps)
            del ot, qt, kt, vt
        row["bound_ms"], row["bound_by"] = _bound(*flash_work(b, s, t, h, hkv, d, causal, dtype), dtype)
        row["bwd_bound_ms"], row["bwd_bound_by"] = _bound(bwd_bytes, bwd_flops, dtype)
        rows[key] = row
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} / {row['library_bwd_ms']:.4f}"
        warm = f" (warm {row['bwd_warm_ms']:.4f} ms)" if "bwd_warm_ms" in row else ""
        log(f"train vjp {key}: {row['variant']} out {err_out:.2e} lse {err_lse:.2e} dq {errs['dq']:.2e} "
            f"dk {errs['dk']:.2e} dv {errs['dv']:.2e} (of scale), backward against flash_bwd max abs "
            f"{err_bwd_plain:.2e}; fwd {row['ms']:.4f} ms, fwd+lse {row['lse_ms']:.4f} ms, plain fwd "
            f"{row['plain_ms']:.3f} ms, backward kernels {row['bwd_ms']:.4f} ms{warm}, flash_bwd "
            f"{row['plain_bwd_ms']:.3f} ms, SDPA fwd / bwd {lib} ms; bounds fwd {row['bound_ms'] * 1e3:.1f} us "
            f"({row['bound_by']}), bwd {row['bwd_bound_ms'] * 1e3:.1f} us ({row['bwd_bound_by']})")
    return rows


def phase_train_step_parity(ref) -> dict:
    """internlm2-1.8b cut to 2 layers at full width, fp32 compute: one
    ``make_train_step`` on the card and on the CPU from the same masters
    and batch (loss 1e-5 and gradients 1e-4 of scale), then
    ``optimizer.update`` on both devices from the CPU's gradients (1e-6 of
    scale): AdamW's first step is about lr * sign(g), so the update is
    pinned on identical gradients, not after two steps from separate ones."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import build
    from repro_torch.models.common import ParamTree, map_tree, tree_leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = dataclasses.replace(get_config(ARCH), num_layers=STEP_PARITY_LAYERS, compute_dtype="float32")
    api = build(cfg)
    ocfg = opt.OptimizerConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    masters = ts.init_state(api, torch.Generator().manual_seed(0), ocfg).params
    batch = synthetic_batch(api, ShapeConfig("parity", STEP_PARITY_SHAPE[1], STEP_PARITY_SHAPE[0], "train"), 0)

    def fresh(dev):
        params = ParamTree(map_tree(lambda p: p.detach().to(dev, copy=True), masters), trainable=True)
        return ts.TrainState(params, opt.init(params, ocfg))

    grads, out = {}, {}
    real_update = opt.update

    def capture(g, state, params, config):
        grads[tree_leaves(params)[0].device.type] = [x.detach().cpu() for x in tree_leaves(g)]
        return real_update(g, state, params, config)

    opt.update = capture
    try:
        for dev in ("cuda", "cpu"):
            state = fresh(dev)
            t0 = time.perf_counter()
            with main_path(ref) if dev == "cuda" else contextlib.nullcontext():
                state, metrics = ts.make_train_step(api, ocfg)(state, {k: x.to(dev) for k, x in batch.items()})
                out[dev] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                                step_s=time.perf_counter() - t0)
            del state, metrics
    finally:
        opt.update = real_update
    loss_err = abs(out["cuda"]["loss"] - out["cpu"]["loss"])
    assert loss_err <= 1e-5 * max(1.0, abs(out["cpu"]["loss"])), out
    g_scale = max(float(g.abs().max()) for g in grads["cpu"])
    g_err = max(float((a - b).abs().max()) for a, b in zip(grads["cuda"], grads["cpu"]))
    assert g_err <= 1e-4 * g_scale, (g_err, g_scale)
    updated = {}
    for dev in ("cuda", "cpu"):
        state = fresh(dev)
        it = iter(grads["cpu"])
        params, _, _ = opt.update(map_tree(lambda p: next(it).to(dev), state.params), state.opt, state.params, ocfg)
        updated[dev] = [p.detach().cpu() for p in tree_leaves(params)]
        del state, params
    p_scale = max(float(p.abs().max()) for p in updated["cpu"])
    p_err = max(float((a - b).abs().max()) for a, b in zip(updated["cuda"], updated["cpu"]))
    assert p_err <= 1e-6 * max(1.0, p_scale), (p_err, p_scale)
    n = sum(p.numel() for p in tree_leaves(masters))
    res = dict(params=n, loss=out["cuda"]["loss"], loss_err=loss_err, grad_err=g_err / g_scale,
               update_err=p_err / max(1.0, p_scale), card_step_s=out["cuda"]["step_s"], cpu_step_s=out["cpu"]["step_s"])
    log(f"train step parity ({cfg.num_layers} layers, d_model {cfg.d_model}, {n:,} parameters, fp32, batch "
        f"{STEP_PARITY_SHAPE}): loss card {out['cuda']['loss']:.6f} cpu {out['cpu']['loss']:.6f} (diff {loss_err:.2e}); "
        f"grad norm {out['cuda']['grad_norm']:.6f} / {out['cpu']['grad_norm']:.6f}; gradients {res['grad_err']:.2e} "
        f"of scale; update on the CPU's gradients {res['update_err']:.2e} of scale; step card "
        f"{res['card_step_s']:.2f} s, cpu {res['cpu_step_s']:.2f} s")
    return res


def _train_trace(state, step_fn, batch) -> dict:
    """One warm step untimed, one timed (host clock to the loss read) and
    one under torch.profiler: device busy, idle share, top kernels, and the
    shares of the flash forward kernels and of the backward's three kernels
    (``flash_bwd_*``, by name; ``flash_bwd_calls`` counts its prologues)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, m = step_fn(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)
    float(m["loss"])
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    kernels = [(e.name(), e.duration_ns() * 1e-3) for e in events]
    busy = sum(us for _, us in kernels) * 1e-6
    fwd = sum(us for name, us in kernels if "flash_tc_kernel" in name or "flash_fwd_kernel" in name) * 1e-6
    bwd = sum(us for name, us in kernels if "flash_bwd_" in name) * 1e-6
    by_name: dict = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = dict(step_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall, kernels=len(kernels),
               flash_fwd_share=fwd / busy, flash_bwd_share=bwd / busy,
               flash_bwd_calls=sum("flash_bwd_dsum_kernel" in name for name, _ in kernels),
               top=[(n[:80], ms) for n, ms in top])
    log(f"train trace: warm step {wall:.4f} s, device busy {busy:.4f} s, idle share {out['idle_share']:.4f}, "
        f"{len(kernels)} kernels; flash forward kernels {fwd:.4f} s ({out['flash_fwd_share']:.4f} of busy), "
        f"backward kernels {bwd:.4f} s ({out['flash_bwd_share']:.4f} of busy, {out['flash_bwd_calls']} calls)")
    for name, ms in top:
        log(f"train trace:   {ms:9.3f} ms  {name[:90]}")
    return out


class _Crash(Exception):
    """Stands for the job dying right after a checkpoint was committed."""


def phase_train_full(ref, counter, device="cuda", reduced=False, keep_ckpt=False) -> dict:
    """internlm2-1.8b at full width and depth through ``launch.train.main``
    (12 steps): once straight through without checkpoints, once with
    ``--ckpt-dir`` and ``--ckpt-every 8`` killed right after step 8's
    checkpoint is committed, and relaunched with the same arguments: the
    relaunch must resume at 8 and give the straight run's losses of steps
    8-11 and its final parameters bitwise (every operation of the step is
    deterministic on the card).  A full state is
    21.19 GiB (fp32 masters and both moments), and the card's machine takes
    at most 45 GiB of disk writes in one call, so the run writes two states
    (step 8, and the relaunch's step 12), not the four of checkpoints every
    4 steps.  Every step launches 2 x 24 flash kernels (the forward, then
    the recompute under remat "full"), all tensor-core; no CUDA tensor
    reaches a plain version.  The launcher places the state on the local
    mesh (1, 1) ("data", "model"): on one device every leaf stays a plain
    tensor.  One warm step is traced on the straight run's final state (the
    step updates it in place).  ``keep_ckpt`` leaves the checkpoint
    directory (``out["ckpt_dir"]``) and the relaunch's final state, from
    which its last checkpoint was written (``out["state"]``), for the
    distributed phase, which deletes both.
    ``device="cpu", reduced=True`` rehearses the same control flow on the
    reduced config (no trace)."""
    import io
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model_zoo import model_flops
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    from torch.distributed.tensor import DTensor

    cfg = get_config(ARCH, reduced=reduced)
    layers = cfg.num_layers
    shape = ShapeConfig("train", 32 if reduced else TRAIN_SEQ, 2 if reduced else TRAIN_BATCH, "train")
    argv = [*TRAIN_ARGS, "--batch", str(shape.global_batch), "--seq", str(shape.seq_len), "--device", device]
    argv += ["--reduced"] if reduced else []
    io_s: dict = {"save": [], "restore": []}
    real_write, real_restore, real_save = ckpt._write, ckpt.restore_checkpoint, ckpt.CheckpointManager.save

    def timed(kind, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                io_s[kind].append(time.perf_counter() - t0)
        return run

    def crash_after(step):
        def save(self, at, state, *, blocking=False):
            real_save(self, at, state, blocking=blocking)
            if at == step:
                self.wait()  # committed
                raise _Crash(step)
        return save

    def traced_step(state):
        """One warm step, traced, on ``state``: (trace, flash launches)."""
        api = build(cfg)
        ocfg = opt.OptimizerConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1))
        batch = next(batch_iterator(api, shape, DataConfig(seed=0), start_step=TRAIN_STEPS, device=device))
        counter.zero()
        trace = dict(step_s=float("nan"))
        if cuda:
            with main_path(ref):
                trace = _train_trace(state, make_train_step(api, ocfg), batch)
        launches = counter.read()
        assert launches["flash"] == (3 * 2 * layers if cuda else 0) == launches["flash_tc"], launches
        assert launches["flash_bwd"] == (3 * layers if cuda else 0), launches
        assert not cuda or trace["flash_bwd_calls"] == layers, trace
        return trace, launches

    tmp = tempfile.mkdtemp(prefix=".train-ckpt-", dir=Path(__file__).resolve().parent)
    ckpt_args = ["--ckpt-dir", tmp, "--ckpt-every", str(TRAIN_CRASH)]
    ckpt._write, ckpt.restore_checkpoint = timed("save", real_write), timed("restore", real_restore)
    runs: dict = {}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        for run, extra in (("straight", []), ("killed", ckpt_args), ("relaunch", ckpt_args)):
            counter.zero()
            buf, t0, report, state = io.StringIO(), time.perf_counter(), None, None
            if run == "killed":
                ckpt.CheckpointManager.save = crash_after(TRAIN_CRASH)
            try:
                with contextlib.redirect_stdout(buf), main_path(ref):
                    report, state = train.main([*argv, *extra])
            except _Crash:
                pass
            finally:
                ckpt.CheckpointManager.save = real_save
            runs[run] = dict(report=report, launches=counter.read(), wall=time.perf_counter() - t0,
                             steps=sorted(ckpt.list_steps(tmp)))
            for line in buf.getvalue().strip().splitlines():
                log(f"train {run} | {line}")
            if run == "straight":
                assert not any(isinstance(x, DTensor) for x in tree_leaves(state)), "one device: plain tensors"
                straight = [p.detach().clone() for p in tree_leaves(state.params)]
                trace, trace_launches = traced_step(state)
                del state
                if cuda:
                    torch.cuda.empty_cache()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        r1, r2 = runs["straight"]["report"], runs["relaunch"]["report"]
        assert runs["killed"]["report"] is None and runs["killed"]["steps"] == [TRAIN_CRASH], runs["killed"]
        assert all(math.isfinite(x) for x in r1.losses + r2.losses), (r1.losses, r2.losses)
        assert r1.losses[-1] < r1.losses[0], f"the loss did not fall: {r1.losses}"
        assert r1.steps_run == TRAIN_STEPS and r2.resumed_from == TRAIN_CRASH and r2.steps_run == TRAIN_STEPS - TRAIN_CRASH
        assert runs["relaunch"]["steps"] == [TRAIN_CRASH, TRAIN_STEPS], runs["relaunch"]
        for name, steps in (("straight", TRAIN_STEPS), ("killed", TRAIN_CRASH), ("relaunch", TRAIN_STEPS - TRAIN_CRASH)):
            got = runs[name]["launches"]
            want = 2 * layers * steps if cuda else 0
            assert got["flash"] == want == got["flash_tc"] and got["flash_bwd"] == want // 2, (name, got)
            assert not any(v for k, v in got.items() if k not in ("flash", "flash_tc", "flash_bwd")), (name, got)
        resumed = [p.detach() for p in tree_leaves(state.params)]
        # Bitwise, with no tolerance: every operation of this step is
        # deterministic on the card (cuBLAS at fixed shapes, the flash
        # forward and backward kernels, which use no atomics, and the index
        # backward's sorted accumulation), so any difference is a fault of
        # the resume.
        loss_diff = max(abs(a - b) for a, b in zip(r2.losses, r1.losses[TRAIN_CRASH:]))
        param_diff = max(float((a - b).abs().max()) for a, b in zip(straight, resumed))
        bitwise = r2.losses == r1.losses[TRAIN_CRASH:] and all(torch.equal(a, b) for a, b in zip(straight, resumed))
        del straight, resumed
        log(f"train resume: {'bitwise' if bitwise else 'DIFFERS'} (loss diff {loss_diff:.3e}, "
            f"parameter diff {param_diff:.3e}); checkpoints {runs['killed']['steps']} after the killed run, "
            f"{runs['relaunch']['steps']} after the relaunch")
        assert bitwise, f"the relaunch differs from the straight run: loss {loss_diff:.3e}, parameters {param_diff:.3e}"
        if not keep_ckpt:
            del state
    finally:
        ckpt._write, ckpt.restore_checkpoint, ckpt.CheckpointManager.save = real_write, real_restore, real_save
        if not keep_ckpt:
            shutil.rmtree(tmp, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    tokens = shape.global_batch * shape.seq_len
    flops = model_flops(cfg, shape)
    launches = {name: r["launches"]["flash"] for name, r in runs.items()}
    bwd_launches = {name: r["launches"]["flash_bwd"] for name, r in runs.items()}
    counts = [r["launches"] for r in runs.values()] + [trace_launches]
    out = dict(
        arch=cfg.name, params=cfg.param_count(), layers=layers, batch=shape.global_batch, seq=shape.seq_len,
        losses=r1.losses, resumed_losses=r2.losses, resume_bitwise=bitwise, loss_diff=loss_diff,
        param_diff=param_diff, step_times=r1.step_times, run_s={k: r["wall"] for k, r in runs.items()},
        save_s=io_s["save"], restore_s=io_s["restore"], peak_gib=peak_gib,
        launches=sum(launches.values()) + trace_launches["flash"], launches_by_run=launches,
        launches_per_step=launches["straight"] / TRAIN_STEPS,
        bwd_launches=sum(bwd_launches.values()) + trace_launches["flash_bwd"], bwd_launches_by_run=bwd_launches,
        bwd_launches_per_step=bwd_launches["straight"] / TRAIN_STEPS, tokens_per_s=tokens / trace["step_s"],
        fma_launches=sum(c["flash"] - c["flash_tc"] for c in counts), bwd_fma_launches=sum(c["flash_bwd_fma"] for c in counts),
        model_flops=flops,
        model_flops_share=flops / trace["step_s"] / BF16_FLOP_PER_S, trace=trace,
        ckpt_dir=tmp if keep_ckpt else None, state=state if keep_ckpt else None,
    )
    log(f"train {cfg.name}: {layers} layers, {cfg.param_count():,} parameters (6ND count), batch "
        f"{shape.global_batch} x {shape.seq_len}; losses {[round(x, 4) for x in r1.losses]}; relaunch "
        f"{[round(x, 4) for x in r2.losses]}; step {trace['step_s']:.4f} s, {out['tokens_per_s']:.0f} tokens/s, "
        f"6ND {flops:.4e} flops = {out['model_flops_share']:.4f} of 989 TFLOP/s; peak {peak_gib:.2f} GiB; "
        f"checkpoint saves {[round(x, 2) for x in io_s['save']]} s, restores {[round(x, 2) for x in io_s['restore']]} s; "
        f"runs {', '.join(f'{k} {r:.1f} s' for k, r in out['run_s'].items())}; flash launches {launches} "
        f"(+ {trace_launches['flash']} traced), backward {bwd_launches} (+ {trace_launches['flash_bwd']} traced)")
    return out


def phase_train(ref, counter) -> dict:
    """Phase 13: the flash VJP, the 2-layer train step against the CPU, and
    the full-size training run with its resume."""
    t0 = time.perf_counter()
    out = dict(vjp=phase_train_vjp(ref))
    torch.cuda.empty_cache()
    out["step_parity"] = phase_train_step_parity(ref)
    torch.cuda.empty_cache()
    out["full"] = phase_train_full(ref, counter, keep_ckpt=True)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase training: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Distributed (phase 14)
# ---------------------------------------------------------------------------


def _qdq_rows(x):
    """The int8 all-to-all's plain version on one rank: each row quantized
    and dequantized in ``moe._q_a2a``'s arithmetic, with no exchange."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale.to(torch.float32)).to(x.dtype)


def _events_per_call(fn) -> int:
    """Device operations (kernels, copies, collectives) of one ``fn()``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(_device_events(prof))


def _warm_us(fn, reps: int = 50) -> float:
    """Mean device µs of back-to-back ``fn()`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def _open_group(device: str):
    """A one-rank process group in this process on a free port (NCCL on
    the card, gloo on the CPU) and the local mesh (1, 1) over it."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("localhost", port, world_size=1, is_master=True)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", store=store, rank=0, world_size=1)
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


def phase_dist_ep(mesh, device="cuda", reduced=False) -> dict:
    """(b) olmoe-1b-7b's MoE block at full width (d 2048, 64 experts top-8,
    expert d_ff 1024; random weights from a seeded generator) on tokens
    (8, 512): ``moe_apply`` under ``use_rules(mesh, TRAIN_RULES)`` (the EP
    path: one rank, so no exchange) against no rule context (the capacity
    path): outputs, aux and the gradients of x and the three expert weights,
    in fp32 (1e-5 of scale; bitwise or not is printed) and bf16 (2e-2 of
    scale, the reference's bf16 tolerance), with both paths' forward +
    backward device times."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models.common import materialize

    cfg = get_config(OLMOE, reduced=reduced)
    b, s = (2, 16) if reduced else (8, 512)
    gen = torch.Generator(device=device).manual_seed(0)
    base = materialize(moe.moe_params(cfg), gen, torch.float32).to_tree()
    x0 = torch.randn(b, s, cfg.d_model, generator=gen, device=device) * 0.3
    cot = torch.randn(b, s, cfg.d_model, generator=gen, device=device)
    names = ("w_gate", "w_up", "w_down")
    out: dict = dict(arch=cfg.name, tokens=(b, s), capacity=moe._capacity(cfg, b * s))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
        p = {k: v.detach().to(torch.float32 if k == "router" else dtype).clone().requires_grad_()
             for k, v in base.items()}
        x = x0.to(dtype).clone().requires_grad_()

        def run(ctx, p=p, x=x, c=c):
            with ctx:
                y, aux = moe.moe_apply(p, x, c)
            grads = torch.autograd.grad((y.to(torch.float32) * cot).sum(), [x] + [p[n] for n in names])
            return [y, aux] + list(grads)

        ep, cap = run(shd.use_rules(mesh, shd.TRAIN_RULES)), run(contextlib.nullcontext())
        labels = ["y", "aux", "dx"] + [f"d{n}" for n in names]
        errs = {k: _rel(a.detach().float(), w.detach().float()) for k, a, w in zip(labels, ep, cap)}
        bitwise = all(torch.equal(a, w) for a, w in zip(ep, cap))
        row = dict(max_rel_err=max(errs.values()), errs=errs, bitwise=bitwise, tol=tol)
        if device == "cuda":
            row["ep_ms"] = device_ms(lambda: run(shd.use_rules(mesh, shd.TRAIN_RULES)), reps=5)
            row["capacity_ms"] = device_ms(lambda: run(contextlib.nullcontext()), reps=5)
        out[str(dtype).removeprefix("torch.")] = row
        log(f"dist ep {cfg.name} {dtype}: EP vs capacity max {row['max_rel_err']:.3e} of scale "
            f"({'bitwise' if bitwise else 'not bitwise'}; tolerance {tol}); "
            f"fwd+bwd EP {row.get('ep_ms', float('nan')):.3f} ms, capacity {row.get('capacity_ms', float('nan')):.3f} ms")
        assert row["max_rel_err"] <= tol, (dtype, errs)
        del ep, cap, p, x
    return out


def phase_dist_a2a(mesh, cap: int, device="cuda", reduced=False) -> dict:
    """(c) the MoE block's two all-to-alls on the group's "model" axis at
    (64, cap, 2048) bf16: the int8 Function's forward and backward against
    its plain row quantize-dequantize (bitwise on one rank), the exact one
    against the identity (bitwise), with µs and device operations per call."""
    from repro_torch.models import moe

    e, d = (8, 64) if reduced else (64, 2048)
    group = mesh.get_group("model")
    gen = torch.Generator(device=device).manual_seed(1)
    buf = torch.randn(e, cap, d, generator=gen, device=device).to(torch.bfloat16).requires_grad_()
    cot = torch.randn(e, cap, d, generator=gen, device=device).to(torch.bfloat16)
    out: dict = dict(shape=(e, cap, d))
    for kind in ("int8", "bf16"):
        y = moe._a2a(buf, group, 0, 1, kind)
        (g,) = torch.autograd.grad(y, buf, cot)
        want_y, want_g = (_qdq_rows(buf.detach()), _qdq_rows(cot)) if kind == "int8" else (buf.detach(), cot)
        ok = torch.equal(y.detach(), want_y) and torch.equal(g, want_g)
        row = dict(bitwise=ok)
        if device == "cuda":
            with torch.no_grad():
                row["fwd_us"] = _warm_us(lambda: moe._a2a(buf, group, 0, 1, kind))
                row["fwd_launches"] = _events_per_call(lambda: moe._a2a(buf, group, 0, 1, kind))
            row["fwd_bwd_us"] = _warm_us(lambda: torch.autograd.grad(moe._a2a(buf, group, 0, 1, kind), buf, cot), 20)
        out[kind] = row
        log(f"dist a2a {kind} {tuple(buf.shape)} bf16 on a 1-rank group: {'bitwise' if ok else 'DIFFERS'} against "
            f"{'its row quantize-dequantize' if kind == 'int8' else 'the identity'}; forward "
            f"{row.get('fwd_us', float('nan')):.1f} us ({row.get('fwd_launches')} device ops), forward + backward "
            f"{row.get('fwd_bwd_us', float('nan')):.1f} us")
        assert ok, kind
    return out


def phase_dist_restore(mesh, ckpt_dir: str, written, device="cuda", reduced=False):
    """(e) the training phase's last checkpoint restored with
    ``shardings=state_shardings(...)`` on the local mesh, against
    ``written``, the unplaced state it was written from (the relaunch's
    final state, which that run had restored from its step-8 checkpoint):
    every leaf bitwise, so the checkpoint is read once.  Returns (row, the
    restored state)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import init_state, state_shardings
    from torch.distributed.tensor import DTensor

    api = build(get_config(ARCH, reduced=reduced))
    ocfg = opt.OptimizerConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1))
    step = ckpt.latest_step(ckpt_dir)
    assert step == TRAIN_STEPS, ckpt.list_steps(ckpt_dir)
    gen = torch.Generator(device=device).manual_seed(5)
    shardings = state_shardings(api, ocfg, mesh, shd.TRAIN_RULES)
    t0 = time.perf_counter()
    placed = ckpt.restore_checkpoint(ckpt_dir, step, init_state(api, gen, ocfg), shardings=shardings)
    _sync(device)
    placed_s = time.perf_counter() - t0
    a, b = tree_leaves(written), tree_leaves(placed)
    assert not any(isinstance(x, DTensor) for x in a + b)
    bitwise = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    row = dict(step=step, leaves=len(b), bitwise=bitwise, placed_s=placed_s)
    log(f"dist restore: step {step} onto the local mesh (1, 1): {len(b)} leaves "
        f"{'bitwise' if bitwise else 'DIFFER'} against the unplaced state it was written from; {placed_s:.2f} s")
    assert bitwise
    del written, a, b
    return row, placed


def phase_dist_pod_mean(params, device="cuda") -> dict:
    """(d) ``make_compressed_pod_mean`` on a one-rank "pod" mesh over a
    whole parameter tree: every leaf within amax / 127 + 1e-6 of itself
    (the reference's bound), with seconds and bytes."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.collectives import make_compressed_pod_mean
    from repro_torch.models.common import map_tree, tree_leaves

    pod = init_device_mesh(device, (1,), mesh_dim_names=("pod",))
    mean = make_compressed_pod_mean(pod, "pod")
    leaves = tree_leaves(params)
    elems = sum(x.numel() for x in leaves)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        got = mean(map_tree(lambda x: x.detach(), params))
        _sync(device)
        secs = time.perf_counter() - t0
        margins = torch.stack([(g - x).abs().max() - (x.abs().max() / 127.0 + 1e-6)
                               for g, x in zip(tree_leaves(got), leaves)])
        worst = float(margins.max())
    row = dict(leaves=len(leaves), elements=elems, fp32_bytes=4 * elems, int32_payload_bytes=4 * elems,
               int8_values=elems, seconds=secs, worst_margin=worst)
    log(f"dist compressed_pod_mean: {len(leaves)} leaves, {elems:,} fp32 elements ({4 * elems / 1e9:.3f} GB; "
        f"int32 sum payload {4 * elems / 1e9:.3f} GB) in {secs:.3f} s; worst leaf error minus its bound "
        f"(amax/127 + 1e-6) {worst:.3e}")
    assert worst <= 0, worst
    del got
    return row


def phase_distributed(ref, counter, train_full: dict, device="cuda", reduced=False) -> dict:
    """Phase 14: (a) a one-rank process group and the local mesh (1, 1);
    (b) EP at olmoe-1b-7b's full width; (c) the two all-to-alls; (d)
    ``compressed_pod_mean`` over internlm2-1.8b's restored parameters;
    (e) the re-shard restore of the training phase's last checkpoint; (f)
    ``--mesh pod`` raising; (g) the training cell's analytic step cost
    beside its measured step.  No hand kernel is on these paths: every
    count must stay 0 and no plain version may see a CUDA tensor."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import costs, train
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    t0 = time.perf_counter()
    out: dict = {}
    counter.zero()
    mesh = _open_group(device)
    try:
        with main_path(ref):
            out["ep"] = phase_dist_ep(mesh, device, reduced)
            out["a2a"] = phase_dist_a2a(mesh, out["ep"]["capacity"], device, reduced)
            try:
                train.main([*TRAIN_ARGS, "--batch", "1", "--seq", "8", "--mesh", "pod", "--device", device])
            except RuntimeError as exc:
                out["pod_mesh_error"] = str(exc)
            assert "needs 256 ranks" in out.get("pod_mesh_error", ""), out.get("pod_mesh_error")
            log(f"dist --mesh pod on one card: {out['pod_mesh_error']}")
            out["restore"], state = phase_dist_restore(mesh, train_full["ckpt_dir"], train_full.pop("state"),
                                                       device, reduced)
            out["pod_mean"] = phase_dist_pod_mean(state.params, device)
            del state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(train_full["ckpt_dir"], ignore_errors=True)
        _sync(device)
        if device == "cuda":
            torch.cuda.empty_cache()
    launches = counter.read()
    assert not any(launches.values()), launches
    cfg = get_config(ARCH, reduced=reduced)
    shape = ShapeConfig("train", train_full["seq"], train_full["batch"], "train")
    cost = costs.step_cost(cfg, shape)
    step_s = train_full["trace"]["step_s"]
    out["cost"] = dict(arch=cfg.name, remat=cfg.remat, batch=shape.global_batch, seq=shape.seq_len, flops=cost.flops,
                       hbm_bytes=cost.hbm_bytes, compute_s=cost.flops / PEAK_FLOPS_BF16,
                       memory_s=cost.hbm_bytes / HBM_BW, measured_step_s=step_s,
                       run_step_s=statistics.median(train_full["step_times"]))
    c = out["cost"]
    log(f"dist step cost {cfg.name} {shape.global_batch} x {shape.seq_len} remat {cfg.remat}: {c['flops']:.4e} FLOPs, "
        f"{c['hbm_bytes']:.4e} HBM bytes; compute term {c['compute_s']:.4f} s at 989 TFLOP/s, memory term "
        f"{c['memory_s']:.4f} s at 3.35 TB/s; measured step {step_s:.4f} s traced, {c['run_step_s']:.4f} s median "
        f"of the run, against {TRAIN_STEP_UNPLACED_S[0]}-{TRAIN_STEP_UNPLACED_S[1]} s before the launcher placed "
        f"its state ({nvidia_smi_line() if device == 'cuda' else 'cpu'})")
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase distributed: {out['phase_s']:.1f} s; hand-kernel launches {launches}")
    return out


# The dry run's cells on the (16, 16) pod (phase 15 (b)): a dense train
# cell, olmoe's under the expert-parallel rules, a prefill and a decode, and
# zamba2's train_4k and prefill_32k, whose Mamba2 blocks split over "model"
# (each must fit a card: ``launch.mesh.HBM_BYTES``).
DRYRUN_CELLS = [(ARCH, "train_4k", "train"), (OLMOE, "train_4k", "ep"), (ARCH, "prefill_32k", "train"),
                (ARCH, "decode_32k", "train"), (ZAMBA, "train_4k", "train"), (ZAMBA, "prefill_32k", "train")]
DRYRUN_FIT = (ZAMBA,)  # the archs whose pod cells phase 15 (b) holds to a card's memory
POD_MODEL = 16  # the pod's "model" axis
BENCH_CHAT_REQUESTS = 9  # the --bench run's chat requests (the first is the cold start)
BENCH_TRAIN_STEPS = 3  # the --bench run's training steps (their losses, to compare trees bitwise)
DRYRUN_PEAK_RTOL = 0.15  # the trace's peak against the real step's max_memory_allocated


def _host_us(fn, calls: int = 1000, rounds: int = 5) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    synchronisation, the median of ``rounds`` rounds (the card drains
    between rounds)."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def phase_dispatch_cost() -> dict:
    """Host µs per call of the decode and flash kernels at the dense chat
    shapes: the wrapper called directly against the ``repro_torch::``
    custom op and ``ops``'s dispatch, which the models call."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, smax, lengths = DECODE_MAIN[0]
    q = torch.randn(b, H, HD, generator=gen, device="cuda").bfloat16()
    kc, vc = (torch.randn(b, smax, HKV, HD, generator=gen, device="cuda").bfloat16() for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    fb, fs, ft, fh, fhkv, fd, causal = FLASH_MAIN[0]
    fq = torch.randn(fb, fs, fh, fd, generator=gen, device="cuda").bfloat16()
    fk, fv = (torch.randn(fb, ft, fhkv, fd, generator=gen, device="cuda").bfloat16() for _ in range(2))
    out = {}
    for name, fn in (("decode_direct", lambda: da.decode_attention(q, kc, vc, lens)),
                     ("decode_op", lambda: torch.ops.repro_torch.decode_attention(q, kc, vc, lens)),
                     ("decode_ops", lambda: ops.decode_attention(q, kc, vc, lens)),
                     ("decode_direct_again", lambda: da.decode_attention(q, kc, vc, lens)),
                     ("flash_direct", lambda: fa.flash_attention(fq, fk, fv, causal=causal)),
                     ("flash_op", lambda: torch.ops.repro_torch.flash_attention(fq, fk, fv, causal)),
                     ("flash_ops", lambda: ops.flash_attention(fq, fk, fv, causal=causal)),
                     ("flash_direct_again", lambda: fa.flash_attention(fq, fk, fv, causal=causal))):
        out[name] = _host_us(fn, 1000 if name.startswith("decode") else 200)
    log("dispatch host us per call (decode B=8 S_max=576; flash B=8 S=T=512), direct / custom op / ops / direct: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()) + f" | {nvidia_smi_line()}")
    return out


def _real_step(cfg, shape, ocfg, counter, device):
    """One train step at ``shape`` on a fresh state through the placed
    launcher's program on the local mesh (1, 1), under
    ``FlopCounterMode``: its FLOPs, flash launches and peak memory above
    what was allocated before the state."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.training.train_step import init_state, jit_train_step, place_state, state_shardings

    mesh = _open_group(device)
    try:
        api = build(cfg)
        cuda = device == "cuda"
        base = torch.cuda.memory_allocated() if cuda else 0
        gen = torch.Generator(device=device).manual_seed(0)
        state = place_state(init_state(api, gen, ocfg), state_shardings(api, ocfg, mesh, shd.TRAIN_RULES))
        batch = next(batch_iterator(api, shape, DataConfig(seed=0), device=device))
        step, _ = jit_train_step(api, ocfg, mesh, shd.TRAIN_RULES)[0](shape)
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        counter.zero()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as flops:
            state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        _sync(device)
        out = dict(flops=float(flops.get_total_flops()), launches=counter.read(), loss=loss,
                   step_s=time.perf_counter() - t0,
                   peak_bytes=(torch.cuda.max_memory_allocated() - base) if cuda else float("nan"),
                   max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else float("nan"))
        del state, batch
    finally:
        dist.destroy_process_group()
        if device == "cuda":
            torch.cuda.empty_cache()
    assert math.isfinite(out["loss"]), out
    return out


def _pod_cell(arch: str, shape_name: str, rules: str, overrides: dict):
    """One pod cell of phase 15 (b), in a worker process: (its record, the
    hand-kernel launches its trace made, the libraries it built)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import disagg_solve as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import dryrun

    counter = LaunchCounter(fa, da, rn, ds)
    counter.zero()
    t0 = time.perf_counter()
    with main_path(ref):
        rec = dryrun.lower_cell(arch, shape_name, rules_name=rules, cfg_overrides=overrides)
    rec["wall_s"] = time.perf_counter() - t0
    return rec, counter.read(), list(kbuild.built)


def phase_dryrun(ref, counter, device="cuda", reduced=False, during=None) -> dict:
    """Phase 15, the dry run (``launch.dryrun``): (a) the training phase's
    cell -- internlm2-1.8b, batch 4 x 2048, remat "full", bf16 on fp32
    masters -- traced on fake tensors on the local mesh (1, 1), then run for
    real on the card: the trace's flash ops must equal the real step's
    flash launches (48 a step), its ``FlopCounterMode`` total the real
    step's, and its ``peak_bytes_est`` the real step's peak within 15 %;
    (b) one cell of each kind on the (16, 16) pod (a fake 256-rank world),
    each with its roofline row and the custom ops its trace reached; (c)
    the dispatch cost of the custom ops against the direct call.  ``during``
    (phase 16) runs after (a) while (b)'s workers trace; its result comes
    back as ``out["during"]``.  No trace
    may launch a kernel, build a library, or hand a CUDA tensor to a plain
    version.  ``device="cpu", reduced=True`` rehearses the control flow on
    the reduced configs (as overrides of the full ones) at 1 x 256 for (a)
    (the plain versions then run, so FLOPs and memory are not compared)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.transformer import n_attn_points
    from repro_torch.training import optimizer as opt

    def cut(arch):  # the reduced config's fields as overrides of the full one (its experts split over 16)
        full, small = get_config(arch), get_config(arch, reduced=True)
        return {f.name: getattr(small, f.name) for f in dataclasses.fields(full)
                if reduced and f.name not in ("name", "num_experts", "top_k")
                and getattr(small, f.name) != getattr(full, f.name)}

    t0 = time.perf_counter()
    out: dict = {}
    # (b)'s pod cells start first, each traced in a worker process of its own, all at once, beside (a)
    pool = ProcessPoolExecutor(len(DRYRUN_CELLS), mp_context=multiprocessing.get_context("spawn"))
    jobs = [pool.submit(_pod_cell, arch, shape_name, rules, cut(arch)) for arch, shape_name, rules in DRYRUN_CELLS]
    overrides = cut(ARCH)
    cfg = dataclasses.replace(get_config(ARCH), **overrides)
    shape = ShapeConfig("train", 256 if reduced else TRAIN_SEQ, 1 if reduced else TRAIN_BATCH, "train")
    ocfg = opt.OptimizerConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1))
    built_before = list(kbuild.built)
    counter.zero()
    with main_path(ref):
        rec = dryrun.lower_cell(ARCH, shape, opt_config=ocfg, cfg_overrides=overrides, mesh="local")
    traced_launches = counter.read()
    assert not any(traced_launches.values()), f"a fake trace launched a kernel: {traced_launches}"
    with main_path(ref):
        real = _real_step(cfg, shape, ocfg, counter, device)
    mem = rec["memory"]
    flash_trace = rec["kernels"].get("flash_attention_lse", 0)
    bwd_trace = rec["kernels"].get("flash_attention_bwd", 0)
    out["local"] = dict(record=rec, real=real, flash_trace=flash_trace, flash_real=real["launches"]["flash"],
                        bwd_trace=bwd_trace, bwd_real=real["launches"]["flash_bwd"],
                        peak_rel=(mem["peak_bytes_est"] - real["peak_bytes"]) / real["peak_bytes"]
                        if device == "cuda" else float("nan"))
    log(f"dryrun (a) {cfg.name} {shape.global_batch} x {shape.seq_len} on the (1, 1) mesh: trace {rec['compile_s']} s on "
        f"fake {rec['device']} tensors; flash ops traced {flash_trace}, launched by the real step "
        f"{real['launches']['flash']}; backward ops traced {bwd_trace}, launched {real['launches']['flash_bwd']}; "
        f"FLOPs traced {rec['flops_per_device']:.6e}, real {real['flops']:.6e}; "
        f"peak_bytes_est {mem['peak_bytes_est'] / 2**30:.3f} GiB (arguments {mem['argument_bytes'] / 2**30:.3f}, "
        f"temp {mem['temp_bytes'] / 2**30:.3f}), real step {real['peak_bytes'] / 2**30:.3f} GiB above the "
        f"{(real['max_memory_allocated'] - real['peak_bytes']) / 2**30:.3f} GiB allocated before "
        f"(max_memory_allocated {real['max_memory_allocated'] / 2**30:.3f} GiB), rel {out['local']['peak_rel']:+.4f}; "
        f"real step {real['step_s']:.3f} s under FlopCounterMode, loss {real['loss']:.4f}")
    if device == "cuda":
        assert flash_trace == real["launches"]["flash"] == 2 * cfg.num_layers, (flash_trace, real["launches"])
        assert bwd_trace == real["launches"]["flash_bwd"] == cfg.num_layers, (bwd_trace, real["launches"])
        assert rec["flops_per_device"] == real["flops"], (rec["flops_per_device"], real["flops"])
        assert abs(out["local"]["peak_rel"]) <= DRYRUN_PEAK_RTOL, out["local"]["peak_rel"]

    t_during = time.perf_counter()
    if during is not None:
        out["during"] = during()
    t_during = time.perf_counter() - t_during

    # (b) the production cells on the pod.
    rows, records = [], {}
    try:
        results = [job.result() for job in jobs]
    finally:
        pool.shutdown()
    for (arch, shape_name, rules), (r, launches, built) in zip(DRYRUN_CELLS, results):
        assert not any(launches.values()), f"a fake trace launched a kernel: {arch} {shape_name} {launches}"
        assert not built, f"a fake trace built a library: {arch} {shape_name} {built}"
        records[f"{arch}_{shape_name}_{rules}"] = r
        rows.append(roofline.analyze_record(r))
        c = dataclasses.replace(get_config(arch), **cut(arch))
        layers = n_attn_points(c) if c.family == "hybrid" else c.num_layers  # its attention layers
        per_step = layers * (1 if c.remat == "none" else 2)  # the forward, then the remat recompute
        # A decode cache whose kv heads do not divide the pod's 16 "model" ranks lies on kv_seq:
        # each layer attends the rank's rows with the lse store, then merges across "model".
        dec = "decode_attention_lse" if c.num_kv_heads % POD_MODEL else "decode_attention"
        want = {"train": {"flash_attention_lse": per_step, "flash_attention_bwd": layers},
                "prefill": {"flash_attention": layers},
                "decode": {dec: layers}}[r["kind"]]
        assert r["kernels"] == want, (arch, shape_name, r["kernels"], want)
        if arch in DRYRUN_FIT and not reduced:
            assert r["memory"]["peak_bytes_est"] <= meshlib.HBM_BYTES, (arch, shape_name, r["memory"])
        log(f"dryrun (b) {arch} {shape_name} rules {r['rules']} on {r['mesh']}: wall {r['wall_s']:.1f} s; "
            f"{r['flops_per_device']:.4e} FLOPs/card, peak {r['memory']['peak_bytes_est'] / 2**30:.2f} GiB, "
            f"collectives {json.dumps(r['collective_bytes'])}, by axis {json.dumps(r['collective_bytes_by_axis'])}, "
            f"kernels {r['kernels']}")
    assert kbuild.built == built_before, f"a fake trace built a library: {kbuild.built[len(built_before):]}"
    for line in roofline.to_markdown(rows).strip().splitlines():
        log(f"dryrun roofline | {line}")
    out["pod"] = dict(records=records, rows=rows)
    if device == "cuda":
        out["dispatch_us"] = phase_dispatch_cost()
    out["phase_s"] = time.perf_counter() - t0 - t_during
    log(f"phase dry run: {out['phase_s']:.1f} s" + (f" beside the {t_during:.1f} s of phase 16" if during else ""))
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism over "model" (phase 16)
# ---------------------------------------------------------------------------

TP_WORLD = 2  # two rank processes on the one card: ("data", "model") = (1, 2)
TP_SEED = 23
# The training steps' batch, cut from the training phase's 4 x 2048 to 2 x
# 2048: each of the split program's all-reduces (six per layer and step with
# remat "full", of a (B, S, 2048) bf16 activation) goes through the host in
# gloo, the only backend that takes two ranks on one card.
TP_BATCH, TP_SEQ, TP_STEPS = 2, TRAIN_SEQ, 2
# The architectures of phase 16, in order: internlm2-1.8b at full width and
# depth, and zamba2-7b at full width, its Mamba2 blocks split on their heads
# (56 of 112 a rank): trained cut to 12 of its 81 layers (two shared-attention
# points, ~2.0e9 parameters, as many as internlm2's; fp32 masters and moments
# of all 81 would not fit a card beside the one-process reference) and served
# from bf16 weights at ``TP_SERVE_LAYERS``' depth.
TP_ARCHS = (ARCH, ZAMBA)
TP_TRAIN_LAYERS = {ZAMBA: 12}
TP_SERVE_LAYERS = {ZAMBA: ZAMBA_SERVE_LAYERS}  # the families phase's depth, for the run's time limit
# The archs whose first moments and logits are held in fp32: a step with fp32
# compute and a serve from fp32 weights, both cut to ``TP_FP32_LAYERS``,
# split against one process.  zamba2's bf16 steps are held by their
# losses and parameters, its bf16 serve by finite logits: the one-process
# bf16 step's own first moments lie O(1) of their scale from the fp32 step's
# in its Mamba2 leaves (dt_bias, a_log, w_dt, the norms; PERF.md section 6),
# and so do its deep bf16 logits from fp32 weights', so no split program can
# be held to them in bf16; both are recorded.
TP_FP32_CHECKS = (ZAMBA,)
TP_FP32_STEPS = 1  # the fp32 steps (after one, the first moment is the gradient itself)
TP_FP32_LAYERS = 4  # the fp32 checks' depth: one shared-attention point and four Mamba2 layers
TP_DECODE = 4  # decode steps after a chat-class prefill (batch 8, prompt 512)
TP_TIMEOUT_S = 900.0
# The split program against the one-process one, both bf16 on the card
# (PERF.md states why): the losses within 2e-2 of their value (a bf16
# product rounds once, the split one rounds each rank's part and its sum:
# ~2^-8 a layer over 24 layers); each gathered parameter within 2 lr a step
# (AdamW's early steps move a weight by ~lr whatever its gradient's size, so
# a gradient element near 0 whose sign the rounding flips moves it by up
# to 2 lr), which a misplaced block (weights ~0.02) would exceed 30-fold;
# each first moment within 5e-2 of its leaf's largest; the logits within
# 5e-2 of their largest magnitude.
# The fp32 steps and serve (``TP_FP32_CHECKS``): losses, first moments and
# logits within 1e-3 of scale.  A rounding of 2^-8 a product moved zamba2's bf16 moments by ~1
# of scale, so fp32's 2^-24 should move them by ~1e-5: the bound leaves 100x,
# and a gradient missing its sum over "model" or read from the wrong columns
# is off by ~1.
TP_TOL = dict(loss_rtol=2e-2, param_lr_factor=2.0, mu_rel=5e-2, logits_rel=5e-2, fp32_rel=1e-3)
# The kv_seq merge: internlm2's decode_32k cache block on the pod's 16
# "model" ranks (B 8 of the data shard's sequences, 2,048 rows a rank).
TP_MERGE = dict(b=8, rows=32768, blocks=16)
# Flash and decode at a rank's heads of internlm2 at "model" 2, 4 and 16 (H
# 8 / 4 / 1 over Hkv 4 / 2 / 1): the phase's training batch, the chat
# class's last decode step.
FLASH_TP = [(TP_BATCH, TP_SEQ, TP_SEQ, H // m, max(HKV // m, 1), HD, True) for m in (2, 4, 16)]
DECODE_TP = [(8, 576, (575,) * 8, H // m, max(HKV // m, 1), HD) for m in (2, 4, 16)]
# The flash VJP at the ranks' training calls (phase 13 (a) holds them as it
# holds ``VJP_CASES``): internlm2 (H 8 over Hkv 4) and zamba2's shared
# attention (H = Hkv 16, d 112) at "model" ``TP_WORLD``, and zamba2's in the
# fp32 step of ``TP_FP32_CHECKS`` too.
FLASH_ZAMBA_RANK = (TP_BATCH, TP_SEQ, TP_SEQ, ZAMBA_H // TP_WORLD, ZAMBA_HKV // TP_WORLD, ZAMBA_HD, True)
VJP_TP = [(TP_BATCH, TP_SEQ, TP_SEQ, H // TP_WORLD, HKV // TP_WORLD, HD, True, torch.bfloat16)] + [
    FLASH_ZAMBA_RANK + (dtype,) for dtype in (torch.bfloat16, torch.float32)]
# The lse store at the serving shapes and at the kv_seq block of a rank
# (2,048 of 32,768 rows; ragged lengths, one block with no live row).
DECODE_KV_BLOCK = (8, 2048, (2048, 2048, 1500, 0, 2048, 1, 700, 2048), H, HKV, HD)
DECODE_LSE = [(b, smax, lengths, H, HKV, HD) for b, smax, lengths in DECODE_MAIN] + [DECODE_KV_BLOCK]


def _gloo_functional_collectives(lib_holder: list) -> None:
    """Send DTensor's functional collectives on CUDA tensors to the c10d
    calls, for a gloo group on one card.  The two ranks of phase 16 share
    one H100, where NCCL refuses two ranks; gloo takes CUDA tensors in
    ``dist.all_reduce`` and ``dist.all_gather_into_tensor`` (what
    ``distributed.tensor_parallel`` issues), but its functional twins,
    which DTensor's redistributions and reductions call, crash the process
    in torch 2.11 (``wait_tensor`` on a gloo CUDA work, on an H100; PERF.md).
    So in the rank processes those ops get CUDA implementations that make
    the same c10d calls synchronously (a reduce-scatter as an all-reduce and
    this rank's block).  ``lib_holder`` keeps the library alive."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def all_reduce(x, reduce_op, group_name):
        pg = _resolve_process_group(group_name)
        y = x.contiguous().clone()
        dist.all_reduce(y, op=ops[reduce_op.lower()], group=pg)
        return y / dist.get_world_size(pg) if reduce_op.lower() == "avg" else y

    def all_gather(x, group_size, group_name):
        x = x.contiguous()
        out = x.new_empty((group_size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=_resolve_process_group(group_name))
        return out

    def reduce_scatter(x, reduce_op, group_size, group_name):
        pg = _resolve_process_group(group_name)
        return all_reduce(x, reduce_op, group_name).chunk(group_size)[dist.get_rank(pg)].contiguous()

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_reduce", all_reduce, "CUDA")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    lib.impl("reduce_scatter_tensor", reduce_scatter, "CUDA")
    lib.impl("wait_tensor", lambda t: t, "CUDA")
    lib_holder.append(lib)


def _tp_leaves(tree) -> list:
    from repro_torch.models.common import tree_leaves

    return tree_leaves(tree)


def tp_rank(argv: list) -> int:
    """One rank of phase 16 (``--tp-rank RANK WORLD DIR DEVICE SIZE
    ARCH[,ARCH...]``): for each architecture in turn, rank 0 runs the
    one-process reference first and frees it, then both ranks run the split
    program (``_tp_arch``); each rank writes ``DIR/rank{RANK}.json``, one
    record per architecture."""
    rank, world, tmp, device, size = int(argv[0]), int(argv[1]), Path(argv[2]), argv[3], argv[4]
    archs = argv[5].split(",")
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank, world_size=world)
    held: list = []
    if device == "cuda":
        _gloo_functional_collectives(held)
    out = {arch: _tp_arch(arch, rank, world, device, size == "reduced") for arch in archs}
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def _tp_arch(arch: str, rank: int, world: int, device: str, reduced: bool) -> dict:
    """Phase 16 for one architecture on this rank: the training steps at
    ``TP_TRAIN_LAYERS``' depth and the serving run at ``TP_SERVE_LAYERS``'
    (full where they name none); rank 0 first runs both as the one-process
    program."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops  # noqa: F401  (registers the custom ops)
    from repro_torch.kernels import ref
    from repro_torch.models import build
    from repro_torch.models.common import layer_specs, logical_axes, materialize, split_mask
    from repro_torch.models.model_zoo import extend_cache
    from repro_torch.models.transformer import compute_dtype, n_attn_points
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import TrainState, batch_shardings, make_train_step, state_shardings

    cfg = get_config(arch, reduced=reduced)
    if reduced:  # the CPU rehearsal holds the control flow in fp32 (bf16 rounding swamps a reduced zamba2)
        cfg = dataclasses.replace(cfg, remat="full", compute_dtype="float32")
    cut, serve_cut = (None, None) if reduced else (TP_TRAIN_LAYERS.get(arch), TP_SERVE_LAYERS.get(arch))
    train_cfg = cfg if cut is None else dataclasses.replace(cfg, num_layers=cut)
    cfg = cfg if serve_cut is None else dataclasses.replace(cfg, num_layers=serve_cut)
    api, train_api = build(cfg), build(train_cfg)
    if arch in TP_FP32_CHECKS:  # the fp32 checks' depth, and the same depth in bf16 for its own rounding's moments
        small = dataclasses.replace(train_cfg, num_layers=min(TP_FP32_LAYERS, train_cfg.num_layers))
        fp32_api, small_api = build(dataclasses.replace(small, compute_dtype="float32")), build(small)
    else:
        fp32_api = small_api = None
    attn_layers = n_attn_points(train_cfg) if train_cfg.family == "hybrid" else train_cfg.num_layers
    ocfg = opt.OptimizerConfig()
    batch_n, seq = (2, 32) if reduced else (TP_BATCH, TP_SEQ)
    serve = dict(batch=2, prompt=16) if reduced else CLASSES[f"{ARCH}/chat"]
    shape = ShapeConfig("train", seq, batch_n, "train")
    batches = [{k: v.to(device) for k, v in synthetic_batch(train_api, shape, i, DataConfig(seed=TP_SEED)).items()}
               for i in range(TP_STEPS)]
    rng = np.random.default_rng(TP_SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (serve["batch"], serve["prompt"]))).to(device)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TP_DECODE, serve["batch"], 1))).to(device)
    gen = lambda: torch.Generator(device=device).manual_seed(TP_SEED)  # noqa: E731
    out: dict = {"rank": rank, "train_layers": train_cfg.num_layers, "layers": cfg.num_layers,
                 "attn_layers": attn_layers}

    def placed(spec_api, dtype, shardings, trainable=False, one_at_a_time=False):
        """The seeded weights placed by ``shardings``; ``one_at_a_time``
        draws them one rank after the other: a stacked leaf is drawn whole in
        fp32 first (zamba2's 81 ``w_zx`` 15.5 GiB), which two ranks at once
        would not fit beside the other's blocks."""
        params = None
        for r in range(world):
            if r == rank or not one_at_a_time:
                params = materialize(spec_api.params_def, gen(), dtype, trainable=trainable)
                shd.place_tree(params, shardings)
                _sync(device)
                if device == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        return params

    def serve_run(s_api, params):
        logits, cache = s_api.prefill(params, {"tokens": prompt})
        cache = extend_cache(s_api, cache, TP_DECODE)
        got = [logits]
        for i, tok in enumerate(steps):
            logits, cache = s_api.decode(params, cache, tok, serve["prompt"] + i)
            got.append(logits)
        return got

    def one_process_serve(s_api, dtype):
        """Rank 0's one-process prefill and decode steps: logits on the host."""
        with torch.no_grad():
            params = materialize(s_api.params_def, gen(), dtype)
            got = [x.float().cpu() for x in serve_run(s_api, params)]
        del params
        _sync(device)
        if device == "cuda":
            torch.cuda.empty_cache()
        return got

    def split_serve(s_api, dtype, want, tag):
        """Both ranks serve from their "model" blocks; the logits (gathered)
        against ``want`` on rank 0: ``{tag}logits_rel`` and
        ``{tag}argmax_equal``."""
        logical = logical_axes(s_api.params_def)
        with torch.no_grad():
            params = placed(s_api, dtype, shd.tree_shardings(logical, layer_specs(s_api.params_def), mesh,
                                                              shd.SERVE_RULES), one_at_a_time=s_api is api)
            t1 = time.perf_counter()
            with shd.use_rules(mesh, shd.SERVE_RULES):
                local = shd.local_view(params, logical, mesh, split=split_mask(logical))
                if s_api.cfg.family == "hybrid":  # the Mamba2 heads and channels each rank runs
                    out["ssm_heads"] = local["layers"][0]["mamba"]["a_log"].shape[0]
                    out["ssm_channels"] = local["layers"][0]["mamba"]["w_out"].shape[0]
                got = serve_run(s_api, local)
                axis = tp.model_axis()
                out["logits_block"] = got[0].shape[-1]
                got = [tp.gather_from_model(x, axis, -1).float().cpu() for x in got]
            _sync(device)
            out[f"{tag}serve_s"] = time.perf_counter() - t1
        out[f"{tag}logits_finite"] = all(bool(torch.isfinite(x).all()) for x in got)
        if rank == 0:
            out[f"{tag}logits_rel"] = max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want))
            out[f"{tag}argmax_equal"] = float(sum(float((g.argmax(-1) == w.argmax(-1)).float().mean())
                                                  for g, w in zip(got, want)) / len(got))
        del params, local, got
        _sync(device)
        if device == "cuda":
            torch.cuda.empty_cache()

    def one_process(t_api, steps, moments=True):
        """Rank 0's one-process steps: (losses, parameters, first moments or
        None), the last two on the host."""
        state = TrainState(params=materialize(t_api.params_def, gen(), torch.float32, trainable=True), opt=None)
        state = state._replace(opt=opt.init(state.params, ocfg))
        step = make_train_step(t_api, ocfg)
        losses = []
        for b in batches[:steps]:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        return (losses, [p.detach().cpu() for p in _tp_leaves(state.params)],
                [m.cpu() for m in _tp_leaves(state.opt.mu)] if moments else None)

    def split_train(t_api, steps, want, moments=True):
        """The split steps on both ranks; rank 0 holds the gathered
        parameters (and with ``moments`` the first moments) against ``want``
        (``one_process``'s)."""
        st_sh = state_shardings(t_api, ocfg, mesh, shd.TRAIN_RULES)
        params = placed(t_api, torch.float32, st_sh.params, trainable=True)
        state = TrainState(params=params, opt=opt.init(params, ocfg))
        del params
        b_sh = batch_shardings(t_api.train_inputs(shape), mesh, shd.TRAIN_RULES)
        step = make_train_step(t_api, ocfg)
        res = dict(losses=[], step_s=[])
        for b in batches[:steps]:
            placed_batch = {k: shd.place(v, b_sh[k]) for k, v in b.items()}
            t1 = time.perf_counter()
            with shd.use_rules(mesh, shd.TRAIN_RULES):
                state, metrics = step(state, placed_batch)
            res["losses"].append(float(metrics["loss"]))
            _sync(device)
            res["step_s"].append(time.perf_counter() - t1)
        leaves = list(zip(_tp_leaves(state.params), _tp_leaves(state.opt.mu)))
        res["model_blocks"] = sum(isinstance(p, DTensor) and any(pl.is_shard() for pl in p.placements)
                                  for p, _ in leaves)
        res["param_err"] = res["mu_rel"] = 0.0
        for i, (p, m) in enumerate(leaves):
            p_full = p.full_tensor() if isinstance(p, DTensor) else p
            m_full = m.full_tensor() if isinstance(m, DTensor) and moments else m
            if rank == 0:
                res["param_err"] = max(res["param_err"], float((p_full.detach().float() - want[1][i].to(device)).abs().max()))
                if moments:
                    m_want = want[2][i].to(device)
                    res["mu_rel"] = max(res["mu_rel"], float((m_full - m_want).abs().max())
                                        / max(float(m_want.abs().max()), 1e-30))
                    del m_want
            del p_full, m_full
        del state, step, metrics, placed_batch, leaves, p, m
        gc.collect()
        _sync(device)
        if device == "cuda":
            torch.cuda.empty_cache()
        return res

    ref_train = ref_fp32 = ref_logits = ref_fp32_logits = None
    if rank == 0:  # the one-process program, alone on the card, freed before the split one starts
        t0 = time.perf_counter()
        ref_train = one_process(train_api, TP_STEPS, moments=fp32_api is None)
        out["ref_losses"] = ref_train[0]
        if fp32_api is not None:
            ref_fp32 = one_process(fp32_api, TP_FP32_STEPS)
            out["ref_fp32_losses"] = ref_fp32[0]
            # the one-process bf16 step's own first moments against the fp32 step's
            out["ref_bf16_mu_rel"] = max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                                         for a, w in zip(one_process(small_api, TP_FP32_STEPS)[2], ref_fp32[2]))
        _sync(device)
        if device == "cuda":
            out["ref_train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.empty_cache()
        ref_logits = one_process_serve(api, compute_dtype(cfg))
        if fp32_api is not None:
            # the one-process bf16 serve's own logits against fp32 weights' at the served depth, then the
            # fp32 serve that the split one is held to
            whole32 = one_process_serve(build(dataclasses.replace(cfg, compute_dtype="float32")), torch.float32)
            out["ref_bf16_logits_rel"] = max(float((g - w).abs().max()) / float(w.abs().max())
                                             for g, w in zip(ref_logits, whole32))
            del whole32
            ref_fp32_logits = one_process_serve(fp32_api, torch.float32)
        if device == "cuda":
            out["ref_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
        out["ref_s"] = time.perf_counter() - t0
    dist.barrier()

    mesh = init_device_mesh(device, (1, world), mesh_dim_names=("data", "model"))
    axis_size = mesh.size(1)
    plain_calls, restore = _watch_plain(ref, PLAIN_NAMES)  # the split program reaches no plain version
    fa.flash_attention.launches = fa.flash_attention.launches_tc = fa.flash_attention_bwd.launches = 0
    da.decode_attention.launches = da.decode_attention.launches_lse = 0
    t0 = time.perf_counter()
    out.update(split_train(train_api, TP_STEPS, ref_train, moments=fp32_api is None))
    out.update(train_flash=fa.flash_attention.launches, train_flash_tc=fa.flash_attention.launches_tc,
               train_flash_bwd=fa.flash_attention_bwd.launches, train_decode=da.decode_attention.launches)
    if device == "cuda":
        out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del ref_train
    if fp32_api is not None:  # the first moments, in fp32 (``TP_FP32_CHECKS``)
        fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
        fa.flash_attention.launches_tc = fa.flash_attention_bwd.launches_fma = 0
        out["fp32"] = split_train(fp32_api, TP_FP32_STEPS, ref_fp32)
        out["fp32"]["flash"], out["fp32"]["flash_bwd"] = fa.flash_attention.launches, fa.flash_attention_bwd.launches
        out["fp32"]["flash_fma"] = fa.flash_attention.launches - fa.flash_attention.launches_tc
        out["fp32"]["flash_bwd_fma"] = fa.flash_attention_bwd.launches_fma
        del ref_fp32
    if device == "cuda":
        out["before_serve_gib"] = torch.cuda.memory_allocated() / 2**30

    if fp32_api is not None:  # in fp32 (``TP_FP32_CHECKS``)
        fa.flash_attention.launches = fa.flash_attention.launches_tc = 0
        split_serve(fp32_api, torch.float32, ref_fp32_logits, "fp32_")
        out["fp32"]["serve_flash_fma"] = fa.flash_attention.launches - fa.flash_attention.launches_tc
    fa.flash_attention.launches = fa.flash_attention.launches_tc = 0
    da.decode_attention.launches = da.decode_attention.launches_lse = 0
    split_serve(api, compute_dtype(cfg), ref_logits, "")
    out.update(vocab=cfg.padded_vocab, serve_flash=fa.flash_attention.launches,
               serve_flash_tc=fa.flash_attention.launches_tc, serve_decode=da.decode_attention.launches,
               serve_decode_lse=da.decode_attention.launches_lse, q_heads=cfg.num_heads // axis_size,
               kv_heads=cfg.num_kv_heads // axis_size, head_dim=cfg.head_dim)
    restore()
    assert not [c for c in plain_calls if c[1] == "cuda"], plain_calls
    out["split_s"] = time.perf_counter() - t0
    out["lr_bound"] = TP_TOL["param_lr_factor"] * ocfg.learning_rate * TP_STEPS
    _sync(device)
    if device == "cuda":
        out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    return out


def phase_kv_seq_merge(counter, device="cuda", reduced=False) -> dict:
    """internlm2 decode_32k's cache block on the pod, its kv_seq split 16
    ways, merged: each block's (out, lse) from the ``decode_attention_lse``
    op at its clipped lengths, ``merge_partials``, against the unsplit
    kernel on the whole cache.  Counts zeroed just before, read after."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import merge_partials

    b, rows, parts = (2, 256, 16) if reduced else tuple(TP_MERGE.values())
    gen = torch.Generator(device=device).manual_seed(TP_SEED)
    q = torch.randn(b, H, HD, generator=gen, device=device).bfloat16()
    kc, vc = (torch.randn(b, rows, HKV, HD, generator=gen, device=device).bfloat16() for _ in range(2))
    lens = torch.tensor([rows, rows - 1, rows // 2 + 3, 1] * (b // 4) if b >= 4 else [rows, rows // 3],
                        dtype=torch.int32, device=device)
    n = rows // parts
    blocks = [(kc[:, r * n:(r + 1) * n].contiguous(), vc[:, r * n:(r + 1) * n].contiguous()) for r in range(parts)]
    local = [(lens - r * n).clamp(0, n).to(torch.int32) for r in range(parts)]

    def merged(parts_out=None):
        pieces = [ops.decode_attention_lse(q, k, v, ln) for (k, v), ln in zip(blocks, local)]
        outs = torch.stack([o for o, _ in pieces])
        if parts_out is not None:
            parts_out.append(outs)
        return merge_partials(outs, torch.stack([lse for _, lse in pieces]))

    counter.zero()
    outs: list = []
    got = merged(outs)
    _sync(device)
    launches = counter.read()
    lse_launches = launches["decode_lse"]
    want = ops.decode_attention(q, kc, vc, lens)
    # Each block's output is rounded to bf16 before the merge (half a step,
    # 2^-9 of it), the merged and the unsplit outputs once each: a weighted
    # mean of the blocks' outputs is off by at most 2^-9 of the largest of
    # them, so |got - want| <= 2^-8 (max_r |out_r| + |want|).
    bound = 2.0**-8 * (outs[0].float().abs().amax(dim=0) + want.float().abs()) + 1e-6
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), f"kv_seq merge: {int((diff > bound).sum())} elements past 2^-8 of their scale"
    err = float(diff.max())
    out = dict(b=b, rows=rows, blocks=parts, err=err, err_rms=_row_err(got, want), launches=launches["decode"],
               lse_launches=lse_launches)
    if device == "cuda":
        out["merged_ms"] = device_ms(merged, reps=10)
        out["unsplit_ms"] = device_ms(lambda: ops.decode_attention(q, kc, vc, lens), reps=10)
    log(f"tp kv_seq merge: {parts} blocks of {n} rows, B {b}: max_abs_err {err:.3e} vs the unsplit kernel, "
        f"{out['err_rms']:.3e} of the row RMS; {out['launches']} decode launches ({lse_launches} with the lse store)"
        + (f"; merged {out['merged_ms']:.4f} ms, unsplit {out['unsplit_ms']:.4f} ms" if device == "cuda" else ""))
    return out


def phase_tp(counter, device="cuda", reduced=False) -> dict:
    """Phase 16: the two rank processes (``tp_rank``) over ``TP_ARCHS``,
    then the kv_seq merge in this process.  Fails unless each split program
    agrees with the one-process one at ``TP_TOL`` and ran through the
    kernels (tensor-core flash at every bf16 launch of the full configs)."""
    import tempfile

    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    _sync(device)
    if device == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = lambda r: [sys.executable, "-X", "faulthandler", str(Path(__file__).resolve()), "--tp-rank",  # noqa: E731
                         str(r), str(TP_WORLD), tmp, device, "reduced" if reduced else "full", ",".join(TP_ARCHS)]
        env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}  # two ranks share the card
        procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(TP_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"tp rank {r} exited {p.returncode}:\n{text[-6000:]}"
                  for r, (p, text) in enumerate(zip(procs, logs)) if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(TP_WORLD)]
    out: dict = dict(world=TP_WORLD, archs={})
    keys = ("train_flash", "train_flash_tc", "train_flash_bwd", "serve_flash", "serve_flash_tc", "serve_decode",
            "serve_decode_lse")
    for arch in TP_ARCHS:
        per = [r[arch] for r in ranks]
        r0 = per[0]
        launches = {k: sum(r[k] for r in per) for k in keys}
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["ref_losses"]))
        out["archs"][arch] = dict(ranks=per, launches=launches, loss_rel=loss_rel)
        full = get_config(arch, reduced=reduced).num_layers
        depth = (f"{r0['layers']} layers" if r0["train_layers"] == r0["layers"] == full else
                 f"training cut to {r0['train_layers']} and serving to {r0['layers']} of {full} layers")
        f32 = r0.get("fp32")
        log(f"tp (1, {TP_WORLD}) {arch} {'reduced' if reduced else 'full width'}, {depth}: losses {r0['losses']} "
            f"against {r0['ref_losses']} one-process (rel {loss_rel:.3e}); gathered parameters max |diff| "
            f"{r0['param_err']:.3e} (bound {r0['lr_bound']:.3e}); first moments "
            + (f"held in fp32 (the one-process bf16 step's own against its fp32 step's {r0['ref_bf16_mu_rel']:.3e}); "
               f"fp32 steps at {TP_FP32_LAYERS} layers: "
               f"losses {f32['losses']} against {r0['ref_fp32_losses']}, parameters {f32['param_err']:.3e}, first "
               f"moments {f32['mu_rel']:.3e} of their scale, step s {f32['step_s']}" if f32 else
               f"{r0['mu_rel']:.3e} of their scale")
            + (f"; fp32 serve at {TP_FP32_LAYERS} layers: logits {r0['fp32_logits_rel']:.3e} of their scale, argmax equal "
               f"{r0['fp32_argmax_equal']:.4f}" if f32 else "")
            + f"; logits {r0['logits_rel']:.3e} of their scale, argmax equal {r0['argmax_equal']:.4f}"
            + (f" (the one-process bf16 serve's own against fp32 weights' {r0['ref_bf16_logits_rel']:.3e})"
               if f32 else "") + "; step s "
            f"{r0['step_s']}; serve s {r0['serve_s']:.2f}; rank heads q {r0['q_heads']} kv {r0['kv_heads']} d "
            f"{r0['head_dim']}" + (f", Mamba2 {r0['ssm_heads']} heads / {r0['ssm_channels']} channels"
                                   if "ssm_heads" in r0 else "") + f"; launches {launches}"
            + (f"; peaks: one-process {r0.get('ref_peak_gib', 0):.2f} GiB, split rank 0 train "
               f"{r0.get('train_peak_gib', 0):.2f} / serve {r0.get('serve_peak_gib', 0):.2f} GiB | "
               f"{nvidia_smi_line()}" if device == "cuda" else ""))
        for r in per:
            rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], r0["ref_losses"]))
            assert rel <= TP_TOL["loss_rtol"], ("tp losses", arch, r["losses"], r0["ref_losses"])
            assert r["losses"] == r0["losses"], f"the model ranks report different {arch} losses"
            assert r["model_blocks"] > 0 and r["logits_block"] * TP_WORLD == r["vocab"], r
            if device == "cuda":  # each attention layer's forward and its remat recompute, a step, and its backward
                assert r["train_flash"] == 2 * r["attn_layers"] * TP_STEPS, (arch, r["train_flash"])
                assert r["train_flash_bwd"] == r["attn_layers"] * TP_STEPS, (arch, r["train_flash_bwd"])
            if "ssm_heads" in r:  # the Mamba2 block runs on the rank's heads
                c = get_config(arch, reduced=reduced)
                assert (r["ssm_heads"], r["ssm_channels"]) == (c.ssm_heads // TP_WORLD, c.d_inner // TP_WORLD), r
        assert r0["param_err"] <= r0["lr_bound"] + 1e-6, ("tp gathered parameters", arch, r0["param_err"],
                                                          r0["lr_bound"])
        assert all(r["logits_finite"] for r in per), (arch, "non-finite split logits")
        if arch in TP_FP32_CHECKS:
            rel = max(abs(a - b) / abs(b) for a, b in zip(f32["losses"], r0["ref_fp32_losses"]))
            assert rel <= TP_TOL["fp32_rel"] and f32["mu_rel"] <= TP_TOL["fp32_rel"], ("tp fp32 steps", arch, f32)
            bound = r0["lr_bound"] * TP_FP32_STEPS / TP_STEPS
            assert f32["param_err"] <= bound + 1e-6, ("tp fp32 parameters", arch, f32["param_err"], bound)
            assert all(r["fp32_logits_finite"] for r in per), (arch, "non-finite fp32 split logits")
            assert r0["fp32_logits_rel"] <= TP_TOL["fp32_rel"], ("tp fp32 logits", arch, r0["fp32_logits_rel"])
        else:
            assert r0["mu_rel"] <= TP_TOL["mu_rel"], ("tp first moments", arch, r0["mu_rel"])
            assert r0["logits_rel"] <= TP_TOL["logits_rel"], ("tp logits", arch, r0["logits_rel"])
        if device == "cuda":
            assert launches["train_flash"] > 0 and launches["serve_flash"] > 0 and launches["serve_decode"] > 0, (
                arch, launches)
            # head_dim 128 and 112 in bf16 are the tensor-core kernel's (the reduced configs' 16 the FMA kernel's)
            assert reduced or (launches["serve_flash_tc"] == launches["serve_flash"]
                               and launches["train_flash_tc"] == launches["train_flash"]), (arch, launches)
    out["launches"] = {k: sum(a["launches"][k] for a in out["archs"].values()) for k in keys}
    # The FMA kernels' launches: the fp32 checks' split step and serve (bf16 takes the tensor cores).
    fp32 = [r[arch]["fp32"] for r in ranks for arch in TP_ARCHS if "fp32" in r[arch]]
    out["launches"]["fp32_flash_fma"] = sum(f["flash_fma"] + f["serve_flash_fma"] for f in fp32)
    out["launches"]["fp32_flash_bwd_fma"] = sum(f["flash_bwd_fma"] for f in fp32)
    out["merge"] = phase_kv_seq_merge(counter, device, reduced)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase tensor parallel: {out['phase_s']:.1f} s")
    return out


PLAIN_NAMES = ("disagg_gram", "flash_attention", "flash_fwd", "flash_bwd", "decode_attention", "rmsnorm")


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
        from repro_torch.kernels import ops  # noqa: F401  (registers the repro_torch:: custom ops)
        from repro_torch.kernels import ref
        from repro_torch.kernels import rmsnorm as rn
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {SRC}: {exc}", file=sys.stderr)
        return 2
    counted = (ds.disagg_gram, fa.flash_attention, fa.flash_attention_bwd, da.decode_attention, rn.rmsnorm)
    plain_names = PLAIN_NAMES

    counter = LaunchCounter(fa, da, rn, ds)
    zero_counts = counter.zero

    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    power = idle_power()
    log(f"idle power: draw {power['idle_w']:.2f} W (median of {power['samples']}), limit {power['limit_w']:.2f} W, "
        f"limit less idle {power['dyn_w']:.2f} W | {smi}")
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
    torch.cuda.empty_cache()
    log(f"before training: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card")
    train = phase_train(ref, counter)
    log("training " + json.dumps({**train, "full": {k: v for k, v in train["full"].items() if k != "state"},
                                  "vjp": {str(k): r for k, r in train["vjp"].items()}}, default=str))
    distributed = phase_distributed(ref, counter, train["full"])
    log("distributed " + json.dumps(distributed, default=str))
    dry = phase_dryrun(ref, counter, during=lambda: phase_tp(counter))  # phase 16 while (b) traces
    tpo = dry.pop("during")
    log("tensor_parallel " + json.dumps(tpo, default=str))
    log("dryrun " + json.dumps({k: v for k, v in dry.items() if k != "pod"}, default=str))
    t0 = time.perf_counter()
    examples = phase_examples(ref, counter)
    log(f"phase examples: {time.perf_counter() - t0:.1f} s; " + json.dumps(examples))

    def new_rows(kernel, keys, dtype="bfloat16"):
        fields = ("err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "warm_ms", "library_warm_ms")
        rows_of = [(k, arows[(kernel, k, dtype)]) for k in keys]
        return [dict(shape=json.loads(json.dumps(k)), **{f: r[f] for f in fields if f in r}) for k, r in rows_of]

    paths = {"dense": (flash_launches, decode_launches), "train": (train["full"]["launches"], 0),
             "dryrun_real_step": (dry["local"]["flash_real"], 0),
             "tensor_parallel": (tpo["launches"]["train_flash"] + tpo["launches"]["serve_flash"],
                                 tpo["launches"]["serve_decode"])}
    paths.update({key: (fam[key]["launches"]["flash"], fam[key]["launches"]["decode"])
                  for key in ("int8", "olmoe", "deepseek", "vlm", "xlstm", "zamba2", "seamless", "granite", "nemotron",
                              "qwen", "launcher")})
    by_path = {k: dict(zip(("flash", "decode"), v)) for k, v in paths.items()}
    bwd_paths = {"train": train["full"]["bwd_launches"], "dryrun_real_step": dry["local"]["bwd_real"],
                 "tensor_parallel": tpo["launches"]["train_flash_bwd"]}  # train_energy's xlstm-350m has no attention
    assert all(bwd_paths.values()), f"a training path launched no flash backward: {bwd_paths}"
    train_row = train["vjp"][_vjp_key(*FLASH_TRAIN, torch.bfloat16)]  # the training path's backward call
    # The FMA kernels' launches by path (fp32 anywhere, bf16 at d 16 and 32):
    # the forward's are its launches less the tensor-core ones.
    tpl = tpo["launches"]
    fma_paths = {"dense": flash_launches - flash_tc, "train": train["full"]["fma_launches"],
                 "dryrun_real_step": dry["local"]["real"]["launches"]["flash"]
                 - dry["local"]["real"]["launches"]["flash_tc"],
                 "tensor_parallel": tpl["train_flash"] - tpl["train_flash_tc"] + tpl["serve_flash"]
                 - tpl["serve_flash_tc"] + tpl["fp32_flash_fma"]}
    fma_paths.update({key: fam[key]["launches"]["flash"] - fam[key]["launches"]["flash_tc"]
                      for key in ("int8", "olmoe", "deepseek", "vlm", "xlstm", "zamba2", "seamless", "granite",
                                  "nemotron", "qwen", "launcher")})
    bwd_fma_paths = {"train": train["full"]["bwd_fma_launches"],
                     "dryrun_real_step": dry["local"]["real"]["launches"]["flash_bwd_fma"],
                     "tensor_parallel": tpl["fp32_flash_bwd_fma"]}
    fp32_vjp = [c for c in VJP_CASES + VJP_TP if c[-1] == torch.float32]
    rank_fwd = train["vjp"][_vjp_key(*FLASH_ZAMBA_RANK, torch.float32)]

    def bwd_rows(cases):
        return [dict(shape=list(_vjp_key(*c)), **_bwd_row(train["vjp"][_vjp_key(*c)])) for c in cases]

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
                 moe_shapes=new_rows("flash_attention", FLASH_MOE), vlm_shapes=new_rows("flash_attention", FLASH_VLM),
                 zamba2_shapes=new_rows("flash_attention", FLASH_ZAMBA),
                 seamless_shapes=new_rows("flash_attention", FLASH_SEAMLESS),
                 cross_shapes=new_rows("flash_attention", FLASH_CROSS),
                 tp_shapes=new_rows("flash_attention", FLASH_TP),
                 dense_shapes=new_rows("flash_attention", FLASH_DENSE),
                 training_shapes=[dict(shape=json.loads(json.dumps(k)), **r) for k, r in train["vjp"].items()],
                 training_launches_per_step=train["full"]["launches_per_step"],
                 fma_source="src/repro_torch/kernels/csrc/flash_attention.cu", fma_launches_by_path=fma_paths,
                 fp32_shapes=new_rows("flash_attention", FLASH_FP32, "float32") + [dict(
                     shape=list(FLASH_ZAMBA_RANK), err=rank_fwd["err_out"], ms=rank_fwd["ms"],
                     plain_ms=rank_fwd["plain_ms"], library_ms=rank_fwd["library_ms"],
                     bound_ms=rank_fwd["bound_ms"], bound_by=rank_fwd["bound_by"])]),
        _summary("flash_attention_bwd", "src/repro/kernels/ref.py:140", sum(bwd_paths.values()),
                 [_bwd_row(train_row)], [list(FLASH_TRAIN)], launches_by_path=bwd_paths,
                 warm_ms=train_row["bwd_warm_ms"],
                 training_shapes=bwd_rows(VJP_CASES), tp_shapes=bwd_rows(VJP_TP),
                 fma_launches_by_path=bwd_fma_paths, fp32_shapes=bwd_rows(fp32_vjp)),
        _summary("decode_attention", "src/repro/kernels/decode_attention.py:119",
                 sum(v["decode"] for v in by_path.values()),
                 [arows[("decode_attention", k, "bfloat16")] for k in DECODE_MAIN], DECODE_MAIN,
                 launches_by_path={k: v["decode"] for k, v in by_path.items()},
                 moe_shapes=new_rows("decode_attention", moe_decode),
                 zamba2_shapes=new_rows("decode_attention", DECODE_ZAMBA),
                 seamless_shapes=new_rows("decode_attention", DECODE_SEAMLESS),
                 static_memory_shapes=new_rows("decode_attention", DECODE_STATIC),
                 dense_shapes=new_rows("decode_attention", DECODE_DENSE)),
        _summary("decode_attention_lse", "src/repro/kernels/decode_attention.py:119", tpo["merge"]["lse_launches"],
                 [arows[("decode_attention_lse", k, "bfloat16")] for k in DECODE_LSE], DECODE_LSE,
                 source="src/repro_torch/kernels/csrc/decode_attention.cu",
                 launches_by_path={"kv_seq_merge": tpo["merge"]["lse_launches"]},
                 no_lse_ms=sum(arows[("decode_attention_lse", k, "bfloat16")]["no_lse_ms"] for k in DECODE_LSE),
                 tp_shapes=new_rows("decode_attention", DECODE_TP)),
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
    """Time the flash, decode-attention and gram kernels of any tree of the
    port.

    ``python3 chip_smoke.py --bench [DIR]`` imports ``repro_torch`` from
    ``DIR`` (default: this checkout's ``src``), so that one call can time
    two trees on one card.  Flash runs at the serving path's main shapes
    (bf16, no lse: serving's call), cold-L2 median and warm per launch; on a
    tree with the hand backward (``fa.flash_attention_bwd``), the backward
    at the training call ``FLASH_TRAIN`` and the ranks' bf16 ``VJP_TP``
    calls too, cold and warm, beside SDPA's backward (cold).  Then the FMA
    kernels in fp32: the forward at ``FLASH_ZAMBA`` and zamba2's
    tensor-parallel rank call ``FLASH_ZAMBA_RANK``, the backward at that
    call, each cold and warm beside SDPA's fp32 time (cold) and the fp32
    FFMA bound.
    Per kernel and shape it prints ``time_decode``'s
    or ``time_gram``'s row (cold and warm, the kernel's and the library
    call's), at decode's main shapes (bf16) and at the gram's main shapes,
    its parity shapes with M >= 64 and those either side of the variants'
    threshold.  Last, ``BENCH_TRAIN_STEPS`` steps of the training phase's
    program through the launcher on the (1, 1) mesh, whose losses two trees
    with the same kernels repeat bitwise where "model" has size 1 (two
    trees whose backward kernels sum in another order may differ after the
    first step, whose loss no backward has touched yet: AdamW's first
    update is about lr * sign(g), and the bf16 compute copy of the masters
    can round a last-bit difference away, so they may also agree).  Decode also runs at a rank's kv_seq block of a 32,768-row
    cache (``DECODE_KV_BLOCK``), and on a tree whose kernel has the lse
    store, with it (``lse_ms``, ``lse_warm_ms``).  For decode it adds ``len1_ms`` (every length 1: the
    launch's fixed cost at that grid), ``host_us`` (the wrapper's host
    time per call over 1,000 calls with no synchronisation, the median of
    five rounds) and ``ops_host_us`` (the same through ``ops``, the
    models' entry).  Then it serves internlm2-1.8b chat at full width
    (``BENCH_CHAT_REQUESTS`` requests) and reports its warm latency and
    decode tokens/s.  The last line is all of it as JSON.
    """
    if not torch.cuda.is_available():
        print("chip_smoke --bench: torch.cuda.is_available() is false; this needs a CUDA GPU", file=sys.stderr)
        return 2
    src = Path(argv[0] if argv else SRC).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import disagg_solve as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | repro_torch from {da.__file__}", flush=True)
    ds.build()
    da.build()
    fa.build()
    out = dict(src=str(src), device=smi, flash={}, decode={}, gram={})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, t, h, hkv, d, causal in FLASH_MAIN:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, t, hkv, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        nbytes = 2.0 * (2 * b * s * h * d + 2 * b * t * hkv * d)
        row = dict(ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
                   warm_ms=warm_ms(lambda *a: fa.flash_attention(*a, causal=causal), (q, k, v), nbytes))
        out["flash"][f"B={b} S={s} T={t}"] = row
        print(f"flash B={b} S={s} T={t} H={h} Hkv={hkv} d={d}: " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
    if hasattr(fa, "flash_attention_bwd"):  # a tree with the hand backward: its bf16 training calls
        import torch.nn.functional as F

        fa.build_bwd()
        out["flash_bwd"] = {}
        for b, s, t, h, hkv, d, causal, dtype in [FLASH_TRAIN + (torch.bfloat16,)] + [
                c for c in VJP_TP if c[-1] == torch.bfloat16]:
            q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn(b, t, hkv, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
            o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
            nbytes = flash_bwd_work(b, s, t, h, hkv, d, causal, dtype)[0]
            row = dict(ms=device_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)),
                       warm_ms=warm_ms(lambda *a: fa.flash_attention_bwd(*a, causal=causal), (q, k, v, o, lse, do),
                                       nbytes))
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
            row["library_ms"] = device_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
            del ot, qt, kt, vt, dot
            out["flash_bwd"][f"B={b} S={s} H={h} Hkv={hkv} d={d}"] = row
            print(f"flash backward B={b} S={s} T={t} H={h} Hkv={hkv} d={d}: "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    # The FMA kernels in fp32: the forward at zamba2's serving shapes and its
    # tensor-parallel rank call, the backward at that call; SDPA's fp32
    # forward and backward beside them (cold).
    import torch.nn.functional as F

    fa.build_bwd()
    out["flash_fp32"], out["flash_bwd_fp32"] = {}, {}
    for b, s, t, h, hkv, d, causal in FLASH_ZAMBA + [FLASH_ZAMBA_RANK]:
        q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn(b, t, hkv, d, generator=gen, device="cuda") for _ in range(2))
        reps = 5 if s * t > 2**22 else 25
        nbytes = flash_work(b, s, t, h, hkv, d, causal, torch.float32)[0]
        row = dict(ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps),
                   warm_ms=warm_ms(lambda *a: fa.flash_attention(*a, causal=causal), (q, k, v), nbytes))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        row["library_ms"] = device_ms(sdpa, reps)
        row["bound_ms"] = _bound(*flash_work(b, s, t, h, hkv, d, causal, torch.float32), torch.float32)[0]
        out["flash_fp32"][f"B={b} S={s} H={h} d={d}"] = row
        print(f"flash fp32 B={b} S={s} T={t} H={h} Hkv={hkv} d={d}: " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
        if (b, s, t, h, hkv, d, causal) == FLASH_ZAMBA_RANK:
            o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
            nbytes = flash_bwd_work(b, s, t, h, hkv, d, causal, torch.float32)[0]
            row = dict(ms=device_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal), reps),
                       warm_ms=warm_ms(lambda *a: fa.flash_attention_bwd(*a, causal=causal), (q, k, v, o, lse, do),
                                       nbytes))
            ot = sdpa()
            dot = do.transpose(1, 2).contiguous()
            row["library_ms"] = device_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), reps)
            row["bound_ms"] = _bound(*flash_bwd_work(b, s, t, h, hkv, d, causal, torch.float32), torch.float32)[0]
            out["flash_bwd_fp32"][f"B={b} S={s} H={h} d={d}"] = row
            print(f"flash backward fp32 B={b} S={s} T={t} H={h} Hkv={hkv} d={d}: "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            del o, lse, ot, dot
        del q, k, v, do, qt, kt, vt
    has_lse = "lse" in inspect.signature(da.decode_attention).parameters
    for b, smax, lengths in DECODE_MAIN + [DECODE_KV_BLOCK[:3]]:
        q = torch.randn(b, H, HD, generator=gen, device="cuda").bfloat16()
        kc, vc = (torch.randn(b, smax, HKV, HD, generator=gen, device="cuda").bfloat16() for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        row = time_decode(da, q, kc, vc, lens, warm=True)
        if has_lse:  # the same launch with the log-sum-exp store
            lse = torch.empty(b, H, dtype=torch.float32, device="cuda")
            nbytes = decode_work(b, H, HKV, HD, lengths, torch.bfloat16)[0] + 4 * b * H
            row["lse_ms"] = device_ms(lambda: da.decode_attention(q, kc, vc, lens, lse=lse))
            row["lse_warm_ms"] = warm_ms(lambda *a: da.decode_attention(*a, lse=lse), (q, kc, vc, lens), nbytes)
        ones = torch.ones_like(lens)
        row["len1_ms"] = device_ms(lambda: da.decode_attention(q, kc, vc, ones))
        row["host_us"] = _host_us(lambda: da.decode_attention(q, kc, vc, lens))
        row["ops_host_us"] = _host_us(lambda: ops.decode_attention(q, kc, vc, lens))  # the models' entry
        out["decode"][f"B={b} S_max={smax} len={lengths[0]}"] = row
        print(f"decode B={b} S_max={smax}: " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    rng = np.random.default_rng(0)
    for g, n, m in BENCH_GRAM:
        c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32)).cuda()
        w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).cuda()
        row = time_gram(ds, c, w, warm=True)
        out["gram"][f"{g}x{n}x{m}"] = row
        print(f"gram G={g} N={n} M={m}: " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    # internlm2-1.8b chat served at full width from bf16 weights: the
    # decode loop is host-bound, so its tokens/s carries any dispatch cost.
    api, _, params = build_model(masters=False)
    chat = {f"{ARCH}/chat": CLASSES[f"{ARCH}/chat"]}
    served = phase_serving(api, params, chat, [f"{ARCH}/chat"] * BENCH_CHAT_REQUESTS)
    out["serve_chat"] = report_serving(served, chat)[f"{ARCH}/chat"]
    del api, params, served
    torch.cuda.empty_cache()
    # The training phase's program for BENCH_TRAIN_STEPS steps through the
    # launcher on the (1, 1) mesh: its losses, to hold two trees' bitwise.
    from repro_torch.launch import train

    report, state = train.main([*TRAIN_ARGS[:2], "--steps", str(BENCH_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                                "--seq", str(TRAIN_SEQ), "--device", "cuda"])
    out["train_losses"] = [float(x) for x in report.losses]
    print(f"train losses {out['train_losses']!r}", flush=True)
    del state
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bench"]:
        sys.exit(bench_main(sys.argv[2:]))
    sys.exit(tp_rank(sys.argv[2:]) if sys.argv[1:2] == ["--tp-rank"] else main())
