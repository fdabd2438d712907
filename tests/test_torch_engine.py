"""Port vs reference: the fleet segment engine.

``run_fleet``, ``run_fleet_gram`` (both CPU backends) and
``run_fleet_sequential`` are fed the reference's ``synthetic_fleet`` arrays
on the shapes of tests/test_batched_engine.py.  Estimates are pinned at
1e-5 of their scale and the gram path against the sequential oracle at
5e-5, as that file pins them; per-tick power at 1e-4 of its scale.  The
scale (``max(1, max|ref|)``) is there because FISTA amplifies last-bit
differences: the reference's own solver moves by ~1e-4 W on the 64-function
shape when its rhs changes by one ulp (see tests/test_torch_core.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as RefEngineConfig
from repro.core.engine import pack_fleet_inputs as ref_pack
from repro.core.engine import run_fleet as ref_run_fleet
from repro.core.engine import run_fleet_gram as ref_run_fleet_gram
from repro.core.engine import run_fleet_sequential as ref_run_fleet_sequential
from repro.core.engine import synthetic_fleet as ref_synthetic_fleet
from repro.core.engine import synthetic_ragged_windows as ref_ragged_windows
from repro_torch.convert import config_from_reference_fields, fleet_inputs_from_numpy
from repro_torch.core.engine import (
    EngineConfig,
    FleetInputs,
    fleet_spectrum,
    pack_fleet_inputs,
    run_fleet,
    run_fleet_gram,
    run_fleet_sequential,
    synthetic_fleet,
)

FLEET_SHAPES = [(2, 8, 32, 64, 0), (3, 5, 20, 10, 1), (1, 4, 16, 8, 2)]


def _np(x):
    return None if x is None else np.asarray(x)


def _port_inputs(ref_inputs):
    return fleet_inputs_from_numpy(*(_np(x) for x in ref_inputs), device="cpu")


def assert_scaled(port, ref, rel, what=""):
    ref = np.asarray(ref, np.float64)
    err = float(np.max(np.abs(port.numpy().astype(np.float64) - ref)))
    assert err <= rel * max(1.0, float(np.abs(ref).max())), (what, err)


def _assert_result(port, ref, rel=1e-5, ticks=True):
    assert_scaled(port.x0, ref.x0, rel, "x0")
    assert_scaled(port.x_final, ref.x_final, rel, "x_final")
    assert_scaled(port.x_trajectory, ref.x_trajectory, rel, "x_trajectory")
    if ticks:
        assert_scaled(port.tick_power, ref.tick_power, 1e-4, "tick_power")
        assert_scaled(port.unattributed, ref.unattributed, 1e-4, "unattributed")


def test_synthetic_fleet_is_the_reference_draw():
    ref = ref_synthetic_fleet(2, 3, 4, 5, seed=9)
    port = synthetic_fleet(2, 3, 4, 5, seed=9, device="cpu")
    for r, p in zip(ref, port):
        if r is None:
            assert p is None
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("b,s,n_w,m,seed", FLEET_SHAPES)
def test_run_fleet_matches_reference(b, s, n_w, m, seed):
    ref_in = ref_synthetic_fleet(b, s, n_w, m, seed=seed)
    _assert_result(
        run_fleet(_port_inputs(ref_in), EngineConfig(), device="cpu"),
        ref_run_fleet(ref_in, RefEngineConfig()),
    )


@pytest.mark.parametrize("backend", ["auto", "einsum"])
@pytest.mark.parametrize("b,s,n_w,m,seed", FLEET_SHAPES)
def test_run_fleet_gram_matches_reference(b, s, n_w, m, seed, backend):
    ref_in = ref_synthetic_fleet(b, s, n_w, m, seed=seed)
    port_in = _port_inputs(ref_in)
    port = run_fleet_gram(port_in, EngineConfig(backend=backend), device="cpu")
    _assert_result(port, ref_run_fleet_gram(ref_in, RefEngineConfig(backend="xla")))
    if backend == "auto":
        return  # "auto" is the einsum on the CPU: one oracle check suffices
    # Against the sequential oracle at test_batched_engine.py's 5e-5.
    seq = run_fleet_sequential(port_in, EngineConfig(), device="cpu")
    assert_scaled(port.x_final, seq.x_final.numpy(), 5e-5, "gram vs sequential")
    assert_scaled(port.x_trajectory, seq.x_trajectory.numpy(), 5e-5, "gram vs sequential")


@pytest.mark.parametrize("b,s,n_w,m,seed", FLEET_SHAPES)
def test_run_fleet_sequential_matches_reference(b, s, n_w, m, seed):
    ref_in = ref_synthetic_fleet(b, s, n_w, m, seed=seed)
    port_in = _port_inputs(ref_in)
    seq = run_fleet_sequential(port_in, EngineConfig(), device="cpu")
    _assert_result(seq, ref_run_fleet_sequential(ref_in, RefEngineConfig()))
    # The batched engine against the port's own oracle.
    bat = run_fleet(port_in, EngineConfig(), device="cpu")
    _assert_result(bat, seq)


def test_dedicated_init_block_and_config_transfer():
    """X_0 over a separate init block, with every config field carried over
    from the reference's EngineConfig."""
    ref_in = ref_synthetic_fleet(3, 4, 12, 6, seed=5)
    init = ref_synthetic_fleet(3, 1, 40, 6, seed=6)
    ref_cfg = RefEngineConfig(init_iters=150, init_ridge_lambda=1e-2, backend="xla")
    import dataclasses

    cfg = config_from_reference_fields(EngineConfig, dataclasses.asdict(ref_cfg))
    assert cfg == EngineConfig(init_iters=150, init_ridge_lambda=1e-2, backend="einsum")
    kw = dict(init_c=init.c[:, 0], init_w=init.w[:, 0])
    ref = ref_run_fleet_gram(ref_in, ref_cfg, **kw)
    port = run_fleet_gram(
        _port_inputs(ref_in), cfg, device="cpu",
        init_c=torch.from_numpy(np.array(kw["init_c"])),
        init_w=torch.from_numpy(np.array(kw["init_w"])),
    )
    _assert_result(port, ref)


def test_conservation_per_tick():
    """tick_power.sum(-1) + unattributed reproduces the measured power, and
    the unattributed channel is zero wherever a function ran."""
    inputs = synthetic_fleet(3, 6, 16, 12, seed=3, device="cpu")
    for engine in (run_fleet, run_fleet_gram):
        res = engine(inputs, EngineConfig(), device="cpu")
        measured = inputs.w.reshape(3, -1)
        recon = res.tick_power.sum(-1) + res.unattributed
        assert float((recon - measured).abs().max()) <= 1e-5 * float(measured.abs().max())
        busy = inputs.c.sum(-1).reshape(3, -1) > 0
        assert float(torch.where(busy, res.unattributed, 0.0).abs().max()) == 0.0


def test_ragged_pack_and_engines_match_reference():
    """Ragged pack-and-mask: same packed batch as the reference, exact zeros
    on padded ticks and masked functions, and the same engine results."""
    b, n, m, step = 3, 50, 6, 8
    lengths, fn_lengths = [50, 27, 8], [6, 4, 6]
    ref_w = ref_ragged_windows(b, n, m, lengths=lengths, seed=4)
    ref_in = ref_pack(*ref_w, step_windows=step, lengths=lengths, fn_lengths=fn_lengths)
    port_in = pack_fleet_inputs(
        *(np.array(x) for x in ref_w), step_windows=step, lengths=lengths,
        fn_lengths=fn_lengths, device="cpu",
    )
    for name, p, r in zip(FleetInputs._fields, port_in, ref_in):
        assert (p is None) == (r is None), name
        if name in ("a", "lat_sum", "lat_sumsq"):
            # Per-step sums of n_w window values, taken in another order.
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, err_msg=name)
        elif p is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
    for engine, ref_engine in (
        (run_fleet, ref_run_fleet),
        (run_fleet_gram, ref_run_fleet_gram),
        (run_fleet_sequential, ref_run_fleet_sequential),
    ):
        port = engine(port_in, EngineConfig(), device="cpu")
        _assert_result(port, ref_engine(ref_in, RefEngineConfig(backend="xla")
                                          if ref_engine is ref_run_fleet_gram else RefEngineConfig()))
        pad = (port_in.mask == 0).reshape(b, -1)
        assert torch.all(port.tick_power[pad] == 0.0) and torch.all(port.unattributed[pad] == 0.0)
        assert torch.all(port.x_final[1, 4:] == 0.0) and torch.all(port.tick_power[1, :, 4:] == 0.0)


def test_pack_rejects_bad_lengths():
    c = np.zeros((2, 10, 3), np.float32)
    w = np.zeros((2, 10), np.float32)
    with pytest.raises(ValueError):
        pack_fleet_inputs(c, w, c, c, c, step_windows=4, lengths=[10, 11], device="cpu")
    with pytest.raises(ValueError):
        pack_fleet_inputs(c, w, c, c, c, step_windows=4, strict=True, device="cpu")
    with pytest.raises(ValueError):
        pack_fleet_inputs(c, w, c, c, c, step_windows=20, device="cpu")
    dense = pack_fleet_inputs(c, w, c, c, c, step_windows=5, device="cpu")
    assert dense.mask is None and dense.c.shape == (2, 2, 5, 3)


def test_mesh_is_not_ported():
    """The node-axis mesh is ported (tests/test_torch_sharded.py): a
    one-entry mesh gives the mesh=None result bit for bit, and a mesh the
    fleet does not tile is refused."""
    from repro_torch.distributed import fleet_mesh

    inputs = synthetic_fleet(2, 2, 4, 3, device="cpu")
    for engine in (run_fleet, run_fleet_gram):
        one = engine(inputs, EngineConfig(), mesh=fleet_mesh(devices=["cpu"]))
        assert torch.equal(one.x_final, engine(inputs, EngineConfig(), device="cpu").x_final)
        with pytest.raises(ValueError, match="not divisible"):
            engine(inputs, EngineConfig(), mesh=fleet_mesh(devices=["cpu"] * 3))


def test_fleet_spectrum_matches_reference(rng):
    from repro.core.engine import fleet_spectrum as ref_fleet_spectrum

    b, m = 3, 5
    x = (np.abs(rng.standard_normal((b, m))) * 10).astype(np.float32)
    lat = (np.abs(rng.standard_normal((b, m))) + 0.1).astype(np.float32)
    inv = rng.integers(0, 4, (b, m)).astype(np.float32)
    cp = (rng.random(b) * 100).astype(np.float32)
    idle = (rng.random(b) * 1000).astype(np.float32)
    ref = ref_fleet_spectrum(*(jnp.asarray(v) for v in (x, lat, inv, cp, idle)))
    port = fleet_spectrum(*(torch.from_numpy(v) for v in (x, lat, inv, cp, idle)))
    for p, r in zip(port, ref):
        assert_scaled(p, r, 1e-6)
