"""The driver of ``score`` traffic: one client in a closed loop, each
invocation a prefill through the port's ``ServeEngine.prefill`` that
returns the last-position logits and the cache it wrote.

Prompts are token ids uniform over the published vocabulary, drawn from the
seed on the device before the window, ``pool`` distinct invocations used in
turn.  The outputs of a sample of invocations, drawn from the seed among
the first ``check.within``, and of the window's last invocation are kept
and compared with the reference once the window has closed.  A traced run
follows the window with a traced slice (``tracing.SLICE``) of further
invocations.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from bench import judge, system, tracing


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float) -> dict:
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving.engine import ServeEngine

    traffic = cell.traffic
    clock = time.perf_counter
    api, weights, prompts, sample = inputs(cell, seed, device, t_start)
    params = system.port_params(weights, torch.bfloat16)
    pool = traffic["pool"]
    engine = ServeEngine(api, ShapeConfig(cell.name, traffic["prompt_tokens"], traffic["batch"], "prefill"), params)
    # Warm-up: kernels and library handles, then as many kept outputs as
    # the window keeps, so that their blocks are in the allocator's cache.
    engine.warmup({"tokens": prompts[0]})
    system.note(t_start, "first call (kernels loaded or built)")
    kept = [engine.prefill({"tokens": prompts[j % pool]}) for j in range(1, len(sample) + 2)]
    del kept
    with tracing.recording(trace, device) as rec:
        engine.prefill({"tokens": prompts[0]})
    unit_ops = tracing.launching_ops(rec) if trace else None
    engine.records.clear()
    energy = _energy(device)
    system.note(t_start, "warm-up done; window opens")
    latencies, outputs = [], {}
    setup_s = clock() - t_start
    e0 = energy.read() if energy else None
    t0 = clock()
    i = 0
    while True:
        ts = clock()
        logits, cache = engine.prefill({"tokens": prompts[i % pool]})
        te = clock()
        latencies.append(te - ts)
        if i in sample:
            outputs[i] = (logits, cache)
        last = (i, logits, cache)
        i += 1
        if te - t0 >= seconds:
            break
    t1 = te
    e1 = energy.read() if energy else None
    system.note(t_start, f"window closed: {i} invocations")
    window = None
    if trace:
        with tracing.traced(True, device) as prof:
            done, ts = 0, clock()
            while True:
                with torch.profiler.record_function("bench::invocation"):
                    engine.prefill({"tokens": prompts[(i + done) % pool]})
                done += 1
                if clock() - ts >= seconds * tracing.SLICE:
                    break
        system.note(t_start, f"traced slice: {done} invocations")
        window = tracing.Window(prof, units=done, rate=i / (t1 - t0), unit_ops=unit_ops, cell=cell.facts(device))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine, params, logits, cache
    outputs[last[0]] = last[1:]
    compared = [(prompts[j % pool], lo, ca) for j, (lo, ca) in sorted(outputs.items())]
    del outputs, last
    numbers = judge.score_numbers(cell.reference, weights, cell.model, compared)
    system.note(t_start, f"{len(compared)} invocations compared with the reference")
    e2e = {
        "invocations_per_s": i / (t1 - t0),
        # quantiles needs two points; a window of one invocation (a CPU rehearsal) has its own latency
        "invocation_p95_s": (statistics.quantiles(latencies, n=20, method="inclusive")[18]
                             if len(latencies) > 1 else latencies[0]),
        "setup_s": setup_s,
    }
    if energy:
        e2e["card_j_per_inv"] = (e1 - e0) / i
        energy.close()
    return {"e2e": e2e, "attempted": i, "failed": 0, "numbers": numbers, "window": window, "memory_peak": peak}


def unit_flops(family, model: dict, traffic: dict) -> float:
    """Model FLOPs of one invocation: a causal prefill of ``batch x
    prompt_tokens`` tokens that forms logits at the last position only."""
    b, s = traffic["batch"], traffic["prompt_tokens"]
    return (2.0 * family.product_weights(model) * b * s + family.attention_flops(model, b, s, s, True)
            + 2.0 * family.unembed_weights(model) * b)


def inputs(cell, seed: int, device: torch.device, t_start: float | None = None) -> tuple:
    """The port's model API, the weights and the prompt pool drawn from the
    seed, and the invocations whose outputs are compared."""
    model, traffic = cell.model, cell.traffic
    api, _ = system.port_model(model, cell.family)
    if t_start is not None:
        system.note(t_start, "the port imported")
    gen = torch.Generator(device=device).manual_seed(seed)
    if t_start is not None:
        system.note(t_start, "the card's context made")
    weights = system.draw_weights(api, cell.family, model, gen, torch.bfloat16)
    shape = (traffic["pool"], traffic["batch"], traffic["prompt_tokens"])
    prompts = torch.randint(0, model["vocab_size"], shape, generator=gen, device=device, dtype=torch.int32)
    check = traffic["check"]
    sample = set(random.Random(seed).sample(range(check["within"]), check["requests"]))
    if t_start is not None:
        system.note(t_start, "weights and prompts drawn")
    return api, weights, prompts, sample


def controls(cell, seed: int, device: torch.device) -> list:
    """[(reading, numbers)] of the control on the seed's inputs at the
    cell's own sizes: the plain reference in fp8 put in the program's place,
    for the invocations a run compares."""
    _, weights, prompts, sample = inputs(cell, seed, device)
    compared = [prompts[j % cell.traffic["pool"]] for j in sorted(sample | {0})]
    ref = cell.reference
    fp8 = [(t, *judge.reference_outputs(ref, weights, cell.model, t, "fp8")) for t in compared]
    return [("control_fp8", judge.score_numbers(ref, weights, cell.model, fp8))]


def _energy(device: torch.device):
    if device.type != "cuda":
        return None
    from bench.energy import EnergyCounter

    return EnergyCounter(device)
