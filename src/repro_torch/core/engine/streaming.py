"""Streaming filter stage: one update per telemetry tick.

``fleet_step`` is the live metering hot path — one
``(FleetStreamState, FleetStep) -> (FleetStreamState, TickAttribution)``
update per tick: the tick's rows go into the carried ring buffer, the
invocation/latency sums accumulate, and at each step boundary the buffer is
reduced by the segment engine's own ``precompute_step_inputs`` and the
batched gram-domain Kalman update runs.  ``run_fleet_stream`` is a loop of
the same ``fleet_step`` over a whole segment, so "scan == tick at a time"
holds by construction, and it shares ``resolve_plan``/``finish_result``
with the segment engines.  ``fleet_stream_reset_slots`` is the slot pool's
claim primitive.

The reference donates the carried state to a jitted step.  Here the state's
tensors are written in place (the ring-buffer row at the host-known
``tick_in_step``, the accumulators, the Kalman state), so they keep their
storage for the whole stream, and the reference's ``lax.cond`` on the
boundary is a host ``if`` on the tick counter: the dispatching thread never
reads the device.  With a ``FleetMesh`` the state is a ``Shards`` tuple,
one state per mesh device, and every entry point dispatches through
``core.engine.sharding``.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine.attribution import _conserved_split
from repro_torch.core.engine.estimate import _init_states
from repro_torch.core.engine.masking import _apply_mask, fold_step_valid
from repro_torch.core.engine.plan import finish_result, resolve_plan
from repro_torch.core.engine.segment import _on_device
from repro_torch.core.engine.sharding import _run_sharded, _sharded_reset, _sharded_step
from repro_torch.core.engine.types import (
    EngineConfig,
    FleetInputs,
    FleetResult,
    FleetStep,
    FleetStreamState,
    Tensor,
    TickAttribution,
)
from repro_torch.core.kalman import KalmanState, kalman_step_gram, precompute_step_inputs
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.sharding import Shards


def fleet_stream_init(
    x0: Tensor,
    n_w: int,
    config: EngineConfig = EngineConfig(),
    *,
    mesh=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetStreamState:
    """Initial streaming state on ``device`` from a (B, M) estimate X_0.

    ``x0`` comes from ``fleet_initial_estimate`` over the init segment, a
    previous session's final state, or another node's estimate (a warm
    handoff at a step boundary).  It is copied, and every carried tensor is
    a separate allocation, because ``fleet_step`` writes them in place.
    ``n_w`` (ticks per Kalman step) sizes the ring buffer.  ``config`` is
    the engine configuration, taken where the reference takes it
    (``run_fleet_stream`` passes it positionally); the initial state does
    not depend on it, in the reference either.

    With ``mesh`` (a ``distributed.sharding.FleetMesh``) the result is a
    ``Shards`` tuple: one state per mesh device over its block of X_0's
    rows (``device`` is then ignored).  Pass the same mesh to every later
    ``fleet_step`` and ``fleet_stream_reset_slots``.
    """
    if mesh is not None:
        mesh.validate(x0.shape[0])
        return Shards(
            fleet_stream_init(x, n_w, config, device=dev)
            for dev, x in zip(mesh.devices, mesh.split(x0))
        )
    dev = resolve_device(device)
    x0 = x0.to(device=dev, dtype=torch.float32, copy=True)
    b, m = x0.shape
    kal = KalmanState(*(t.clone() for t in _init_states(x0)))
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return FleetStreamState(
        kalman=kal,
        c_buf=zeros(b, n_w, m),
        w_buf=zeros(b, n_w),
        a=zeros(b, m),
        lat_sum=zeros(b, m),
        lat_sumsq=zeros(b, m),
        tick_in_step=0,
        step_idx=0,
    )


def fleet_step(
    state: FleetStreamState,
    step: FleetStep,
    config: EngineConfig = EngineConfig(),
    *,
    mesh=None,
) -> tuple[FleetStreamState, TickAttribution]:
    """One streaming tick: buffer it, and update at a step boundary.

    The step length n_w is the ring buffer's shape (``state.c_buf.shape[1]``).
    A mid-step tick writes the tick's rows into the ring buffer at
    ``tick_in_step`` and accumulates the invocation/latency sums, all in
    place.  Every n_w-th tick reduces the full buffer through
    ``precompute_step_inputs`` and runs the batched ``kalman_step_gram``
    (the update rule of ``run_fleet_gram``), writes the new Kalman state
    into the carried one and zeroes the accumulators.  The tick's causal
    conserved attribution uses the freshest estimate.

    ``step``'s tensors must lie on the state's device.  Ragged fleets
    (``step.valid``): invalid node-ticks are folded to zero telemetry first
    (``masking.fold_step_valid``), so they add nothing and attribute 0 W.

    The returned state holds the same tensors as ``state`` (updated) and the
    advanced counters; callers rebind, as with the reference's donated
    state.  The attribution's tensors are fresh: a consumer on another
    thread may read them after later ticks have updated the state.

    With ``mesh`` the state is the ``Shards`` of ``fleet_stream_init(...,
    mesh=mesh)``: the tick's rows are split over the shards, each shard
    advances on its device, and the attribution is joined on the mesh's
    first device.
    """
    if mesh is not None:
        return _sharded_step(fleet_step, state, step, config, mesh)
    step = fold_step_valid(step)
    kcfg = config.kalman
    n_w = state.c_buf.shape[1]
    k = state.tick_in_step
    state.c_buf[:, k].copy_(step.c)
    state.w_buf[:, k].copy_(step.w)
    state.a.add_(step.a)
    state.lat_sum.add_(step.lat_sum)
    state.lat_sumsq.add_(step.lat_sumsq)
    boundary = k + 1 >= n_w
    kal = state.kalman
    if boundary:
        inp = precompute_step_inputs(
            state.c_buf, state.w_buf, state.a, state.lat_sum, state.lat_sumsq, kcfg
        )
        new, _ = kalman_step_gram(kal, inp, kcfg)
        for carried, updated in zip(kal, new):
            carried.copy_(updated)
        for acc in (state.a, state.lat_sum, state.lat_sumsq):
            acc.zero_()
    tick_power, unattributed = _conserved_split(step.c * kal.x, step.w, config.delta)
    att = TickAttribution(
        tick_power=tick_power,
        unattributed=unattributed,
        x=kal.x.clone(),
        step_completed=boundary,
    )
    return state._replace(
        tick_in_step=0 if boundary else k + 1,
        step_idx=state.step_idx + int(boundary),
    ), att


def fleet_stream_reset_slots(
    state: FleetStreamState, reset: Tensor, x0: Tensor, *, mesh=None
) -> FleetStreamState:
    """Rewrite every slot flagged in ``reset`` ((B,) 1.0/0.0, on the state's
    device) to a fresh tenant, in place: its Kalman row becomes
    ``kalman_init`` of its row of ``x0`` ((B, M); ignored where ``reset`` is
    0), and its ring-buffer rows and partial-step accumulators are zeroed.
    The fleet's ``tick_in_step``/``step_idx`` are untouched: the new tenant
    joins the step clock mid-step.  Returns ``state`` (callers rebind).
    With ``mesh`` the flags and X_0 rows are split over the shards."""
    if mesh is not None:
        return _sharded_reset(fleet_stream_reset_slots, state, reset, x0, mesh)
    r = reset.to(torch.float32)
    rb = r[:, None] > 0
    fresh = _init_states(x0.to(torch.float32))
    for carried, init in zip(state.kalman, fresh):
        carried.copy_(torch.where(rb, init, carried))
    keep = 1.0 - r
    state.c_buf.mul_(keep[:, None, None])
    state.w_buf.mul_(keep[:, None])
    for acc in (state.a, state.lat_sum, state.lat_sumsq):
        acc.mul_(keep[:, None])
    return state


def fleet_ticks(inputs: FleetInputs) -> FleetStep:
    """Explode segment inputs into a time-major (T, B, ...) tick stream.

    T = S * n_w ticks, each step's invocation/latency statistics placed on
    its first *valid* tick (``argmax`` of the step's mask: the first maximum
    wins).  A ragged ``inputs.mask`` becomes the per-tick ``valid`` flags.
    ``ticks.at(t)`` is tick t, ready for ``fleet_step``.
    """
    return _fleet_ticks_masked(_apply_mask(inputs))


def _fleet_ticks_masked(inputs: FleetInputs) -> FleetStep:
    """``fleet_ticks`` of inputs whose masks are already folded in."""
    b, s, n_w, m = inputs.c.shape
    tm = lambda x: torch.movedim(x.reshape((b, s * n_w) + tuple(x.shape[3:])), 0, 1)
    if inputs.mask is None:
        first = torch.zeros((b, s), dtype=torch.int64, device=inputs.c.device)
        valid = None
    else:
        first = torch.argmax(inputs.mask, dim=-1)              # (B, S)
        valid = tm(inputs.mask.to(inputs.w.dtype))             # (T, B)
    onehot = torch.nn.functional.one_hot(first, n_w).to(inputs.a.dtype)  # (B, S, n_w)
    place = lambda x: onehot[..., None] * x[:, :, None, :]
    return FleetStep(
        c=tm(inputs.c), w=tm(inputs.w), a=tm(place(inputs.a)),
        lat_sum=tm(place(inputs.lat_sum)), lat_sumsq=tm(place(inputs.lat_sumsq)),
        valid=valid,
    )


def run_fleet_stream(
    inputs: FleetInputs,
    config: EngineConfig = EngineConfig(),
    *,
    init_c: Tensor | None = None,
    init_w: Tensor | None = None,
    with_ticks: bool = True,
    mesh=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetResult:
    """The segment engine as a loop of ``fleet_step`` over every tick.

    Same contract as ``run_fleet``: X_0 from one batched NNLS over the init
    block (``init_c``/``init_w``, else the whole segment), then every one of
    the T = S * n_w ticks through ``fleet_step`` — the code the live session
    runs.  The trajectory collects the boundary ticks' estimates;
    ``tick_power`` is the segment engines' smoothed-within-step attribution,
    for comparability.  ``config.backend`` is ignored: the streaming
    reduction is the plain contraction, as in the reference.  ``mesh``
    shards the node axis as in ``run_fleet``.
    """
    if mesh is not None:
        return _run_sharded(run_fleet_stream, inputs, config, init_c, init_w, with_ticks, mesh)
    inputs, init_c, init_w = _on_device(inputs, init_c, init_w, device)
    plan = resolve_plan(inputs, config, init_c=init_c, init_w=init_w)
    inputs = plan.inputs
    x0 = plan.initial_estimate()
    b, s, n_w, m = inputs.c.shape
    state = fleet_stream_init(x0, n_w, config, device=x0.device)
    ticks = _fleet_ticks_masked(inputs)
    traj = [x0.new_zeros((b, 0, m))]
    for t in range(s * n_w):
        state, att = fleet_step(state, ticks.at(t), config)
        if att.step_completed:
            traj.append(att.x[:, None])
    return finish_result(
        plan, final_state=state.kalman, traj=torch.cat(traj, dim=1), x0=x0,
        with_ticks=with_ticks,
    )
