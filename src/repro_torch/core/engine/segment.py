"""Segment filter stages: batched, gram-hoisted, and sequential-oracle runs.

Each engine here is ``resolve_plan`` → a filter stage → ``finish_result``
(``core.engine.plan``); this module contains only what differs between the
paths:

    ``run_fleet``            every node's steps filtered in one loop over
                             steps, batched over nodes, on the raw
                             (B, S, n_w, M) window blocks.
    ``run_fleet_gram``       the O(M^2)-per-step variant: window statistics
                             are hoisted into one batched gram pass first
                             (the CUDA kernel on the card, einsum on the
                             CPU), so the step loop never touches windows.
    ``run_fleet_sequential`` the oracle: Python loops over nodes and steps
                             calling ``kalman_step``.

The reference's batch-1 branches exist only to keep XLA bitwise and have no
twin here.  Each entry point takes ``device=`` and moves its inputs there;
``mesh`` (a ``distributed.sharding.FleetMesh``) dispatches through
``core.engine.sharding`` instead, each shard re-entering the unsharded
engine on its own device.
"""

from __future__ import annotations

import torch

from repro_torch.core.disaggregation import solve_nnls_gram
from repro_torch.core.engine.estimate import _init_states, _node_init_gram
from repro_torch.core.engine.plan import finish_result, resolve_plan
from repro_torch.core.engine.sharding import _run_sharded
from repro_torch.core.engine.types import EngineConfig, FleetInputs, FleetResult, Tensor
from repro_torch.core.kalman import (
    KalmanState,
    kalman_init,
    kalman_step,
    precompute_step_inputs,
    run_kalman_fleet,
    run_kalman_fleet_gram,
)
from repro_torch.device import DEFAULT_DEVICE, resolve_device

def _on_device(inputs, init_c, init_w, device):
    dev = resolve_device(device)
    move = lambda t: None if t is None else t.to(dev)
    return inputs.to(dev), move(init_c), move(init_w)


def run_fleet(
    inputs: FleetInputs,
    config: EngineConfig = EngineConfig(),
    *,
    init_c: Tensor | None = None,
    init_w: Tensor | None = None,
    with_ticks: bool = True,
    mesh=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetResult:
    """The batched engine: one batched X_0 NNLS (over ``init_c``/``init_w``
    when given, else over all steps), then all B nodes x S steps filtered
    in one loop over steps, then conserved per-tick attribution.

    Ragged fleets: with ``inputs.mask`` set, masked ticks are folded to
    zero telemetry before any stage runs; fully-masked steps leave a node's
    Kalman state untouched.

    With ``mesh`` the node axis is split over the mesh devices and these
    same stages run on each node block on its device (``device`` is then
    ignored); the result lies on the mesh's first device, pinned to the
    unsharded one at 1e-5 of scale and equal to it bit for bit on a
    one-device mesh."""
    if mesh is not None:
        return _run_sharded(run_fleet, inputs, config, init_c, init_w, with_ticks, mesh)
    inputs, init_c, init_w = _on_device(inputs, init_c, init_w, device)
    plan = resolve_plan(inputs, config, init_c=init_c, init_w=init_w)
    inputs = plan.inputs
    x0 = plan.initial_estimate()
    final, traj = run_kalman_fleet(
        _init_states(x0), inputs.c, inputs.w, inputs.a,
        inputs.lat_sum, inputs.lat_sumsq, config.kalman,
    )
    return finish_result(plan, final_state=final, traj=traj, x0=x0, with_ticks=with_ticks)


def run_fleet_gram(
    inputs: FleetInputs,
    config: EngineConfig = EngineConfig(),
    *,
    init_c: Tensor | None = None,
    init_w: Tensor | None = None,
    with_ticks: bool = True,
    mesh=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetResult:
    """Gram-hoisted engine: the X_0 gram and every step's gram/rhs are
    assembled by ``config.backend`` (the CUDA kernel on the card under
    ``"auto"``), then an O(M^2)-per-step fleet loop that never touches the
    window dimension.  Same update rule as ``run_fleet``; equal up to float
    reassociation of the hoisted contractions.  ``mesh`` shards the node
    axis as in ``run_fleet``: each shard's call assembles its own grams, on
    its own node block."""
    if mesh is not None:
        return _run_sharded(run_fleet_gram, inputs, config, init_c, init_w, with_ticks, mesh)
    inputs, init_c, init_w = _on_device(inputs, init_c, init_w, device)
    plan = resolve_plan(inputs, config, init_c=init_c, init_w=init_w, use_backend=True)
    inputs = plan.inputs
    x0 = plan.initial_estimate()
    step_inputs = precompute_step_inputs(
        inputs.c, inputs.w, inputs.a, inputs.lat_sum, inputs.lat_sumsq,
        config.kalman, gram_fn=plan.gram_fn,
    )
    final, traj = run_kalman_fleet_gram(_init_states(x0), step_inputs, config.kalman)
    return finish_result(plan, final_state=final, traj=traj, x0=x0, with_ticks=with_ticks)


def run_fleet_sequential(
    inputs: FleetInputs,
    config: EngineConfig = EngineConfig(),
    *,
    init_c: Tensor | None = None,
    init_w: Tensor | None = None,
    with_ticks: bool = True,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetResult:
    """Sequential-reference oracle: loops nodes x steps calling the per-step
    ``kalman_step``, with a per-node X_0 loop over the plan's init block.
    Ragged fleets go through the same mask fold as the batched engines."""
    inputs, init_c, init_w = _on_device(inputs, init_c, init_w, device)
    plan = resolve_plan(inputs, config, init_c=init_c, init_w=init_w)
    inputs = plan.inputs
    b, s, n_w, m = inputs.c.shape
    eye = config.init_lam * torch.eye(m, dtype=torch.float32, device=inputs.c.device)
    x0s = []
    for i in range(b):
        gram, rhs = _node_init_gram(plan.init_c[i], plan.init_w[i])
        x0s.append(solve_nnls_gram(gram + eye, rhs, iters=config.init_iters))
    x0 = torch.stack(x0s)
    finals, trajs = [], []
    for i in range(b):
        state = kalman_init(m, x0=x0[i])
        xs = []
        for j in range(s):
            state, x = kalman_step(
                state, inputs.c[i, j], inputs.w[i, j], inputs.a[i, j],
                inputs.lat_sum[i, j], inputs.lat_sumsq[i, j], config.kalman,
            )
            xs.append(x)
        finals.append(state)
        trajs.append(torch.stack(xs))
    state = KalmanState(*(torch.stack(leaves) for leaves in zip(*finals)))
    return finish_result(
        plan, final_state=state, traj=torch.stack(trajs), x0=x0, with_ticks=with_ticks
    )
