"""The port's analytic step cost (``repro_torch.launch.costs``) against the
reference's ``repro.launch.costs``, and ``repro_torch.__version__``.

``TestCosts`` of ``tests/test_misc_core.py`` mirrored: the dense forward
near the 2*N*D convention; the cost model's FLOPs against a count taken
from the program itself on a small loop-free model
(``torch.utils.flop_counter.FlopCounterMode`` in place of XLA's
``cost_analysis``); a decode step memory-bound against the H100's balance,
989e12 / 3.35e12 ~ 295 FLOP/byte (``launch.mesh``; the reference's v5e
balance is ~240).  Then ``forward_flops`` and ``step_cost`` equal to the
reference's, item for item, for every runnable cell.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro
from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import get_shape as r_get_shape
from repro.launch import costs as r_costs
import repro_torch
from repro_torch.configs.registry import get_config, get_shape, runnable_cells
from repro_torch.configs.shapes import DECODE_32K, TRAIN_4K
from repro_torch.launch import costs
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16


def test_dense_forward_close_to_2nd():
    cfg = get_config("granite-3-8b")
    fwd = costs.forward_flops(cfg, TRAIN_4K)["total"]
    two_nd = 2.0 * cfg.param_count() * TRAIN_4K.global_batch * TRAIN_4K.seq_len
    assert 0.9 < fwd / two_nd < 1.5, fwd / two_nd


def test_cost_model_vs_counted_unrolled():
    d, f, s, b = 64, 256, 128, 4
    w1, w2, x = torch.randn(d, f), torch.randn(f, d), torch.randn(b, s, d)
    with FlopCounterMode(display=False) as counter:
        torch.tanh(x @ w1) @ w2
    got = counter.get_total_flops()
    want = 2 * b * s * d * f * 2
    assert 0.9 < got / want < 1.2, (got, want)


def test_step_cost_decode_memory_dominated():
    c = costs.step_cost(get_config("granite-3-8b"), DECODE_32K)
    balance = PEAK_FLOPS_BF16 / HBM_BW
    assert 290 < balance < 300
    assert c.flops / c.hbm_bytes < balance


@pytest.mark.parametrize(("arch", "shape"), runnable_cells())
def test_costs_match_reference(arch, shape):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    sh, r_sh = get_shape(shape), r_get_shape(shape)
    assert costs.forward_flops(cfg, sh) == r_costs.forward_flops(r_cfg, r_sh)
    for accum in (1, 4):
        got, want = costs.step_cost(cfg, sh, accum_steps=accum), r_costs.step_cost(r_cfg, r_sh, accum_steps=accum)
        assert (got.flops, got.hbm_bytes, got.details) == (want.flops, want.hbm_bytes, want.details)
        n = 256
        assert got.per_device(n).flops == want.per_device(n).flops


def test_version():
    assert repro_torch.__version__ == repro.__version__ == "1.0.0"
