"""The driver of ``train`` traffic: the port's train step
(``training/train_step.py``, built as ``launch/train.py`` builds it: AdamW
on fp32 masters, the compute dtype of the configuration, its activation
checkpointing, placed on the local (1, 1) mesh under the training rules),
driven step after step on token rows drawn from the seed on the device.

Set-up builds the one train state and steps it through the compared steps
(``compared``), reading each step's loss, the first gradient as the
optimizer holds it after one step (its first moment over 1 - beta1), and,
after the last compared step, each leaf's change from the drawn weights.
The window then drives the same state on; a traced run follows it with a
traced slice (``tracing.SLICE``) of further steps.  The reference follows
the compared steps from the same weights and rows once the window has
closed.  No checkpoint is written.
"""

from __future__ import annotations

import gc
import time

import torch

from bench import judge, system, tracing


def _rows(model: dict, traffic: dict, gen: torch.Generator, device: torch.device):
    """``pool`` batches of token rows, uniform over the published vocabulary,
    and their labels: the next token, -1 after a row's last."""
    shape = (traffic["pool"], traffic["batch"], traffic["seq"])
    tokens = torch.randint(0, model["vocab_size"], shape, generator=gen, device=device, dtype=torch.int32)
    labels = torch.cat([tokens[..., 1:], torch.full_like(tokens[..., :1], -1)], dim=-1)
    return tokens, labels


def unit_flops(family, model: dict, traffic: dict) -> float:
    """Model FLOPs of one step: 6 N D over the layers' products and the
    unembedding, plus three times the forward's causal attention.
    Recomputation under activation checkpointing is not counted."""
    tokens = traffic["batch"] * traffic["seq"]
    n = family.product_weights(model) + family.unembed_weights(model)
    return 6.0 * n * tokens + 3.0 * family.attention_flops(model, traffic["batch"], traffic["seq"],
                                                           traffic["seq"], True)


def _norms(family, tree, vocab: int, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(family.published(k, t.detach(), vocab).to(torch.float32))) * scale
            for k, t in system.flat_state(tree).items()}


def _start(cell, api, seed: int, device: torch.device) -> dict:
    """The fp32 masters as the seed draws them, before any step."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return system.draw_weights(api, cell.family, cell.model, gen, torch.float32)


def compared(cell, api, seed: int, step, state, batches: list, beta1: float, trace: bool, device, t_start: float):
    """Steps ``state`` through ``batches`` (the compared steps) and reads
    the program: (state, {"losses", "first_grad", "change"}, the last
    step's recording or None).  The change is taken from the masters drawn
    again from the seed."""
    family, vocab = cell.family, cell.model["vocab_size"]
    program = {"losses": []}
    rec = None
    for j, batch in enumerate(batches):
        with tracing.recording(trace and j == len(batches) - 1, device) as rec:
            state, metrics = step(state, batch)
            program["losses"].append(float(metrics["loss"]))
        system.note(t_start, f"compared step {j + 1}")
        if j == 0:
            program["first_grad"] = _norms(family, state.opt.mu, vocab, 1.0 / (1.0 - beta1))
    start = _start(cell, api, seed, device)
    now = system.flat_state(state.params)
    program["change"] = {
        k: float(torch.linalg.vector_norm(family.published(k, now[k].detach(), vocab) - family.published(k, t, vocab)))
        for k, t in cell.reference.leaf_paths(start, cell.model).items()}
    return state, program, rec


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float) -> dict:
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import TrainState, make_train_step, place_state, state_shardings

    model, traffic = cell.model, cell.traffic
    clock = time.perf_counter
    api, cfg = system.port_model(model, cell.family)
    system.note(t_start, "the port imported")
    if cfg.remat != traffic["remat"]:
        raise ValueError(f"the port's {cfg.name} checkpoints activations by {cfg.remat!r}, the traffic says "
                         f"{traffic['remat']!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    system.note(t_start, "the card's context made")
    masters = system.draw_weights(api, cell.family, model, gen, torch.float32)
    tokens, labels = _rows(model, traffic, gen, device)
    system.note(t_start, "masters and rows drawn")
    pool, steps = traffic["pool"], traffic["check"]["steps"]
    batches = [{"tokens": tokens[j], "labels": labels[j]} for j in range(steps)]
    ocfg = opt.OptimizerConfig(**traffic["optimizer"])
    with process_group(device.type):
        mesh, rules = make_local_mesh(device.type), shd.TRAIN_RULES
        params = system.port_params(masters, torch.float32).requires_grad_(True)
        with shd.use_rules(mesh, rules):
            state = place_state(TrainState(params=params, opt=opt.init(params, ocfg)),
                                state_shardings(api, ocfg, mesh, rules))
            step = make_train_step(api, ocfg)
            state, program, rec = compared(cell, api, seed, step, state, batches, ocfg.beta1, trace, device, t_start)
            unit_ops = tracing.launching_ops(rec) if trace else None
            system.note(t_start, "changes read; window opens")
            done = 0
            setup_s = clock() - t_start
            t0 = clock()
            while True:
                j = (steps + done) % pool
                state, metrics = step(state, {"tokens": tokens[j], "labels": labels[j]})
                float(metrics["loss"])
                te = clock()
                done += 1
                if te - t0 >= seconds:
                    break
            t1 = te
            system.note(t_start, f"window closed: {done} steps")
            window = None
            if trace:
                with tracing.traced(True, device) as prof:
                    more, ts = 0, clock()
                    while True:
                        j = (steps + done + more) % pool
                        with torch.profiler.record_function("bench::train_step"):
                            state, metrics = step(state, {"tokens": tokens[j], "labels": labels[j]})
                            float(metrics["loss"])
                        more += 1
                        if clock() - ts >= seconds * tracing.SLICE:
                            break
                system.note(t_start, f"traced slice: {more} steps")
                window = tracing.Window(prof, units=more, rate=done / (t1 - t0), unit_ops=unit_ops,
                                        cell=cell.facts(device))
            peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
            del state, metrics, params, masters, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    start = _start(cell, api, seed, device)
    reference = cell.reference.train(start, [(b["tokens"], b["labels"]) for b in batches], model,
                                     traffic["optimizer"], z_loss=traffic["z_loss"])
    numbers = judge.train_numbers(program, reference)
    system.note(t_start, f"{steps} steps compared with the reference")
    e2e = {"train_tokens_per_s": done * traffic["batch"] * traffic["seq"] / (t1 - t0), "setup_s": setup_s}
    return {"e2e": e2e, "attempted": done, "failed": 0, "numbers": numbers, "window": window, "memory_peak": peak}


def controls(cell, seed: int, device: torch.device) -> list:
    """[(reading, numbers)] on the seed's weights and rows at the cell's own
    sizes, each put in the program's place: ``control_fp8``, the plain
    reference in fp8; ``half_batch``, the reference in fp32 on the first
    half of each batch's rows, its mean over those.  A state left unchanged
    by the step reads 1 on ``change_err`` by that number's definition and
    is not run."""
    api, _ = system.port_model(cell.model, cell.family)
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = system.draw_weights(api, cell.family, cell.model, gen, torch.float32)
    tokens, labels = _rows(cell.model, cell.traffic, gen, device)
    ref, traffic = cell.reference, cell.traffic
    steps, opt, z = traffic["check"]["steps"], traffic["optimizer"], traffic["z_loss"]
    full = [(tokens[j], labels[j]) for j in range(steps)]
    half = [(t[: t.shape[0] // 2], lab[: lab.shape[0] // 2]) for t, lab in full]
    want = ref.train(weights, full, cell.model, opt, z_loss=z)
    return [("control_fp8", judge.train_numbers(ref.train(weights, full, cell.model, opt, z_loss=z,
                                                          precision="fp8"), want)),
            ("half_batch", judge.train_numbers(ref.train(weights, half, cell.model, opt, z_loss=z), want))]
