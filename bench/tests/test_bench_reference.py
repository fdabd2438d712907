"""The plain reference agrees with ``repro_torch`` at the configurations'
REDUCED sizes on the CPU, both computing in fp32: the prefill's
last-position logits and cache rows, and three training steps' losses,
first gradients and parameter changes."""

import dataclasses

import pytest
import torch

from bench import judge, system
from bench.tests.conftest import small_cell

NAMES = ["granite-3-8b", "internlm2-1.8b"]


def _fp32_port(cell):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config(cell.model["port"]["arch"], reduced=True), compute_dtype="float32")
    return build(cfg)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_agrees(name):
    cell = small_cell(f"{name}.score_4k" if name == "granite-3-8b" else f"{name}.score_16x1k")
    api = _fp32_port(cell)
    gen = torch.Generator().manual_seed(3)
    weights = system.draw_weights(api, cell.family, cell.model, gen, torch.float32)
    tokens = torch.randint(0, cell.model["vocab_size"], (3, 40), generator=gen)
    with torch.no_grad():
        logits, cache = api.prefill(system.port_params(weights, torch.float32), {"tokens": tokens})
    got = judge.score_numbers(cell.reference, weights, cell.model, [(tokens, logits, cache)])
    assert got["logits_err"] < 1e-5 and got["cache_err"] < 1e-5, got


def test_training_agrees():
    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.distributed import sharding as shd
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import TrainState, make_train_step, place_state, state_shardings

    cell = small_cell("internlm2-1.8b.train_4x2k")
    api = _fp32_port(cell)
    gen = torch.Generator().manual_seed(5)
    ref, family = cell.reference, cell.family
    weights = system.draw_weights(api, family, cell.model, gen, torch.float32)
    start = {k: v.clone() for k, v in ref.leaf_paths(weights, cell.model).items()}
    tokens = torch.randint(0, cell.model["vocab_size"], (3, 2, 24), generator=gen, dtype=torch.int32)
    labels = torch.cat([tokens[..., 1:], torch.full_like(tokens[..., :1], -1)], dim=-1)
    o = {**cell.traffic["optimizer"], "learning_rate": 1e-2, "warmup_steps": 1}
    want = ref.train(weights, [(tokens[j], labels[j]) for j in range(3)], cell.model, o, z_loss=1e-4)
    ocfg = opt.OptimizerConfig(**o)
    got = {"losses": []}
    with process_group("cpu"):
        mesh = make_local_mesh("cpu")
        params = system.port_params(weights, torch.float32).requires_grad_(True)
        with shd.use_rules(mesh, shd.TRAIN_RULES):
            state = place_state(TrainState(params=params, opt=opt.init(params, ocfg)),
                                state_shardings(api, ocfg, mesh, shd.TRAIN_RULES))
            step = make_train_step(api, ocfg)
            for j in range(3):
                state, m = step(state, {"tokens": tokens[j], "labels": labels[j]})
                got["losses"].append(float(m["loss"]))
                if j == 0:
                    got["first_grad"] = {k: float(torch.linalg.vector_norm(family.published(k, t, 256))) / 0.1
                                         for k, t in system.flat_state(state.opt.mu).items()}
            now = system.flat_state(state.params)
            got["change"] = {k: float(torch.linalg.vector_norm(family.published(k, now[k].detach(), 256) - t))
                             for k, t in start.items()}
    numbers = judge.train_numbers(got, want)
    assert numbers["loss_err"] < 1e-5 and numbers["grad_err"] < 1e-4 and numbers["change_err"] < 1e-4, numbers
