"""Port vs reference: the streaming engine (``core.engine.streaming``).

``run_fleet_stream`` is fed the reference's ``synthetic_fleet`` arrays on the
shapes of tests/test_streaming_engine.py; estimates are pinned at 1e-5 of
their scale and per-tick power at 1e-4, as that file pins them (the scale,
``max(1, max|ref|)``, is there because FISTA amplifies last-bit differences;
see tests/test_torch_engine.py).  Tick-at-a-time ``fleet_step`` equals the
port's own ``run_fleet_stream`` bitwise, since both run the same code.  One
stream state, carried across from the reference as numpy, starts both
packages' ``fleet_step`` and ``fleet_stream_reset_slots`` (exact).  The
carried buffers keep their storage for a whole stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as RefEngineConfig
from repro.core.engine import fleet_initial_estimate as ref_initial_estimate
from repro.core.engine import fleet_step as ref_fleet_step
from repro.core.engine import fleet_stream_init as ref_stream_init
from repro.core.engine import fleet_stream_reset_slots as ref_reset_slots
from repro.core.engine import fleet_ticks as ref_fleet_ticks
from repro.core.engine import pack_fleet_inputs as ref_pack
from repro.core.engine import run_fleet_stream as ref_run_fleet_stream
from repro.core.engine import synthetic_fleet as ref_synthetic_fleet
from repro_torch.convert import fleet_inputs_from_numpy, fleet_step_from_numpy, stream_state_from_numpy
from repro_torch.core.engine import (
    EngineConfig,
    fleet_initial_estimate,
    fleet_step,
    fleet_stream_init,
    fleet_stream_reset_slots,
    fleet_ticks,
    run_fleet,
    run_fleet_stream,
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


def _assert_result(port, ref, rel=1e-5):
    for name in ("x0", "x_final", "x_trajectory"):
        assert_scaled(getattr(port, name), getattr(ref, name), rel, name)
    assert_scaled(port.tick_power, ref.tick_power, 1e-4, "tick_power")
    assert_scaled(port.unattributed, ref.unattributed, 1e-4, "unattributed")


def _ref_state_numpy(state):
    return stream_state_from_numpy(
        [np.asarray(leaf) for leaf in state.kalman],
        *(np.asarray(x) for x in state[1:]),
        device="cpu",
    )


def _ragged_inputs(b=3, n=95, m=6, step=20, lengths=(95, 47, 60), seed=4):
    rng = np.random.default_rng(seed)
    c = jnp.asarray(np.abs(rng.standard_normal((b, n, m))) * (rng.random((b, n, m)) < 0.5), jnp.float32)
    w = jnp.asarray(rng.random((b, n)) * 50.0, jnp.float32)
    a = jnp.asarray(rng.integers(0, 3, (b, n, m)), jnp.float32)
    return ref_pack(c, w, a, a * 0.5, a * 0.25, step_windows=step, lengths=list(lengths))


@pytest.mark.parametrize("b,s,n_w,m,seed", FLEET_SHAPES)
def test_run_fleet_stream_matches_reference(b, s, n_w, m, seed):
    ref_in = ref_synthetic_fleet(b, s, n_w, m, seed=seed)
    port = run_fleet_stream(_port_inputs(ref_in), EngineConfig(), device="cpu")
    _assert_result(port, ref_run_fleet_stream(ref_in, RefEngineConfig()))
    # The stream is the segment engine re-expressed: equal to run_fleet.
    seg = run_fleet(_port_inputs(ref_in), EngineConfig(), device="cpu")
    _assert_result(port, seg)


def test_run_fleet_stream_ragged_matches_reference():
    ref_in = _ragged_inputs()
    port = run_fleet_stream(_port_inputs(ref_in), EngineConfig(), device="cpu")
    _assert_result(port, ref_run_fleet_stream(ref_in, RefEngineConfig()))
    # Padded ticks attribute exactly 0 W.
    mask = np.asarray(ref_in.mask).reshape(3, -1)
    assert float(port.tick_power.numpy()[mask == 0].max(initial=0.0)) == 0.0


def test_fleet_step_tick_at_a_time_equals_scan():
    """Tick-at-a-time dispatch == ``run_fleet_stream``, bitwise, with the
    boundary flags every n_w ticks and the state-carry counters."""
    b, s, n_w, m = 2, 4, 8, 6
    inputs = _port_inputs(ref_synthetic_fleet(b, s, n_w, m, seed=3))
    cfg = EngineConfig()
    scan = run_fleet_stream(inputs, cfg, device="cpu")
    state = fleet_stream_init(fleet_initial_estimate(inputs.c, inputs.w, cfg), n_w, device="cpu")
    ticks = fleet_ticks(inputs)
    boundary_xs, flags = [], []
    for t in range(s * n_w):
        state, att = fleet_step(state, ticks.at(t), cfg)
        flags.append(att.step_completed)
        if att.step_completed:
            boundary_xs.append(att.x)
    assert flags == [(t + 1) % n_w == 0 for t in range(s * n_w)]
    torch.testing.assert_close(state.kalman.x, scan.x_final, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack(boundary_xs, dim=1), scan.x_trajectory, rtol=0, atol=0)
    assert state.tick_in_step == 0 and state.step_idx == s
    assert float(state.a.abs().max()) == 0.0


def test_fleet_step_from_carried_reference_state():
    """One stream state, carried across from the reference mid-step, starts
    both packages' ``fleet_step``: per-tick estimates and attribution agree
    at 1e-5 / 1e-4 of scale over the following steps, ragged ticks too."""
    ref_in = _ragged_inputs(b=3, n=80, m=5, step=10, lengths=(80, 36, 52), seed=6)
    cfg = RefEngineConfig()
    x0 = ref_initial_estimate(ref_in.c, ref_in.w, cfg)
    ref_ticks = ref_fleet_ticks(ref_in)
    ref_state = ref_stream_init(x0, 10, cfg)
    for t in range(13):  # into the second step
        ref_state, _ = ref_fleet_step(ref_state, jax.tree.map(lambda l: l[t], ref_ticks), config=cfg)
    state = _ref_state_numpy(ref_state)
    assert state.tick_in_step == 3 and state.step_idx == 1
    for t in range(13, 80):
        tick = jax.tree.map(lambda l: l[t], ref_ticks)
        ref_state, ref_att = ref_fleet_step(ref_state, tick, config=cfg)
        state, att = fleet_step(state, fleet_step_from_numpy(*(_np(x) for x in tick), device="cpu"), EngineConfig())
        assert att.step_completed == bool(ref_att.step_completed)
        assert_scaled(att.x, ref_att.x, 1e-5, f"x at {t}")
        assert_scaled(att.tick_power, ref_att.tick_power, 1e-4, f"tick_power at {t}")
        assert_scaled(att.unattributed, ref_att.unattributed, 1e-4, f"unattributed at {t}")
    assert state.step_idx == int(ref_state.step_idx) == 8


def test_live_attribution_conserved_per_tick():
    """Attributed power + unattributed == measured on every tick, and the
    unattributed channel is zero wherever something ran."""
    b, s, n_w, m = 3, 3, 10, 8
    inputs = _port_inputs(ref_synthetic_fleet(b, s, n_w, m, seed=5, density=0.3))
    cfg = EngineConfig()
    state = fleet_stream_init(fleet_initial_estimate(inputs.c, inputs.w, cfg), n_w, device="cpu")
    ticks = fleet_ticks(inputs)
    for t in range(s * n_w):
        tick = ticks.at(t)
        state, att = fleet_step(state, tick, cfg)
        recon = att.tick_power.sum(-1) + att.unattributed
        np.testing.assert_allclose(recon.numpy(), tick.w.numpy(), atol=1e-3)
        busy = tick.c.sum(-1) > 0
        assert float(att.unattributed[busy].abs().max(), ) == 0.0


def test_stream_state_warm_handoff():
    """A stream resumes from another's state carried over as numpy (fresh
    storage, as across a controller restart): equal to the unsplit stream,
    bitwise."""
    b, s, n_w, m = 2, 6, 8, 5
    inputs = _port_inputs(ref_synthetic_fleet(b, s, n_w, m, seed=7))
    cfg = EngineConfig()
    whole = run_fleet_stream(inputs, cfg, device="cpu")
    state = fleet_stream_init(fleet_initial_estimate(inputs.c, inputs.w, cfg), n_w, device="cpu")
    ticks = fleet_ticks(inputs)
    half = (s // 2) * n_w + 3  # mid-step: the ring buffer's rows carry over too
    for t in range(half):
        state, _ = fleet_step(state, ticks.at(t), cfg)
    resumed = stream_state_from_numpy(
        [leaf.numpy() for leaf in state.kalman], *(x.numpy() for x in state[1:6]),
        state.tick_in_step, state.step_idx, device="cpu",
    )
    assert resumed.c_buf.data_ptr() != state.c_buf.data_ptr()
    for t in range(half, s * n_w):
        resumed, _ = fleet_step(resumed, ticks.at(t), cfg)
    torch.testing.assert_close(resumed.kalman.x, whole.x_final, rtol=0, atol=0)


def test_reset_slots_matches_reference_exactly():
    """``fleet_stream_reset_slots`` on one state carried across mid-step:
    the port's in-place reset equals the reference's, bit for bit."""
    ref_in = ref_synthetic_fleet(4, 3, 10, 6, seed=8)
    cfg = RefEngineConfig()
    ref_ticks = ref_fleet_ticks(ref_in)
    ref_state = ref_stream_init(ref_initial_estimate(ref_in.c, ref_in.w, cfg), 10, cfg)
    for t in range(14):
        ref_state, _ = ref_fleet_step(ref_state, jax.tree.map(lambda l: l[t], ref_ticks), config=cfg)
    state = _ref_state_numpy(ref_state)
    reset = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
    x0 = np.abs(np.random.default_rng(9).standard_normal((4, 6))).astype(np.float32)
    x0[1, 2] = 0.0  # a zero row entry: ``seen`` starts False there
    ptr = state.c_buf.data_ptr()
    got = fleet_stream_reset_slots(state, torch.from_numpy(reset), torch.from_numpy(x0))
    want = ref_reset_slots(ref_state, jnp.asarray(reset), jnp.asarray(x0))
    assert got.c_buf.data_ptr() == ptr
    for g, w in zip(got.kalman, want.kalman):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in ("c_buf", "w_buf", "a", "lat_sum", "lat_sumsq"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert (got.tick_in_step, got.step_idx) == (int(want.tick_in_step), int(want.step_idx))


def test_fleet_ticks_ragged_matches_reference_exactly():
    """The time-major tick stream of a ragged fleet (statistics on each
    step's first valid tick, ``valid`` flags from the mask) is the
    reference's, exactly."""
    ref_in = _ragged_inputs()
    got = fleet_ticks(_port_inputs(ref_in))
    want = ref_fleet_ticks(ref_in)
    for name in ("c", "w", "a", "lat_sum", "lat_sumsq", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_carried_buffers_keep_their_storage():
    """The gate's storage half: every carried buffer of the stream state is
    updated in place for a whole stream (boundaries included)."""
    b, s, n_w, m = 2, 3, 5, 4
    inputs = _port_inputs(ref_synthetic_fleet(b, s, n_w, m, seed=11))
    cfg = EngineConfig()
    state = fleet_stream_init(fleet_initial_estimate(inputs.c, inputs.w, cfg), n_w, device="cpu")
    carried = lambda st: [t.data_ptr() for t in (*st.kalman, *st[1:6])]
    before = carried(state)
    assert len(set(before)) == len(before), "carried tensors must not alias"
    ticks = fleet_ticks(inputs)
    xs = []
    for t in range(s * n_w):
        state, att = fleet_step(state, ticks.at(t), cfg)
        assert att.x.data_ptr() not in before  # emitted tensors are fresh
        xs.append(att.x)
    assert carried(state) == before
    # An emitted estimate is not overwritten by later boundaries.
    assert not torch.equal(xs[n_w - 1], xs[-1])


def test_stream_init_copies_x0_and_mesh_raises():
    x0 = torch.ones(2, 3)
    state = fleet_stream_init(x0, 4, device="cpu")
    assert state.kalman.x.data_ptr() != x0.data_ptr()
    # The node-axis mesh is ported (tests/test_torch_sharded.py); what it
    # refuses is a fleet that does not tile it and an unsharded state.
    from repro_torch.distributed import fleet_mesh

    three, two = fleet_mesh(devices=["cpu"] * 3), fleet_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        fleet_stream_init(x0, 4, mesh=three)
    assert fleet_stream_init(x0, 4, mesh=two)[1].kalman.x.data_ptr() != x0.data_ptr()
    ticks = fleet_ticks(_port_inputs(ref_synthetic_fleet(2, 1, 4, 3, seed=1)))
    with pytest.raises(ValueError, match="one state per device"):
        fleet_step(state, ticks.at(0), mesh=two)
    with pytest.raises(ValueError, match="one state per device"):
        fleet_stream_reset_slots(state, torch.zeros(2), x0, mesh=two)
    with pytest.raises(ValueError, match="not divisible"):
        run_fleet_stream(_port_inputs(ref_synthetic_fleet(2, 1, 4, 3, seed=1)), mesh=three, device="cpu")
