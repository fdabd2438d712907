"""Mesh-dispatch stage: the B-node axis over a ``FleetMesh``.

Every sharded runner of the engine package lives here — the segment
engines', the streaming step's and the slot reset's — so mesh dispatch is
written in one stage.  Where the reference wraps the local function in
``shard_map``, each runner here splits its inputs over the mesh
(``FleetMesh.split``), runs the *unsharded* local function on each shard on
that shard's device, one after the other from the calling thread, and joins
the per-node outputs on the mesh's first device.  Per-node Kalman and
disaggregation math is node-independent, so no shard reads another's data;
fleet-level reductions live in ``distributed.sharding``.

On a one-device mesh the split and the join are identities (no copy, no
launch), so every ``mesh=`` path gives the mesh=None result bit for bit.
"""

from __future__ import annotations

from repro_torch.core.engine.masking import _apply_mask
from repro_torch.core.engine.types import FleetResult
from repro_torch.distributed.sharding import Shards


def _run_sharded(fn, inputs, config, init_c, init_w, with_ticks, mesh) -> FleetResult:
    """Run a segment engine (``run_fleet``, ``run_fleet_gram`` or
    ``run_fleet_stream``) shard by shard over ``mesh``.

    Without an init block each shard's engine derives X_0 from its own
    (mask-folded) inputs.  With only one of ``init_c``/``init_w`` the
    missing one defaults to the *masked* inputs, as in the reference, so a
    ragged fleet's padding never reaches the init gram.
    """
    mesh.validate(inputs.c.shape[0])
    if (init_c is None) != (init_w is None):
        masked = _apply_mask(inputs)
        init_c = masked.c if init_c is None else init_c
        init_w = masked.w if init_w is None else init_w
    parts = [
        fn(shard, config, init_c=ic, init_w=iw, with_ticks=with_ticks, device=dev)
        for dev, (shard, ic, iw) in zip(mesh.devices, mesh.split((inputs, init_c, init_w)))
    ]
    return mesh.join(parts)


def _check_shards(state, mesh) -> None:
    if not isinstance(state, Shards) or len(state) != mesh.num_devices:
        raise ValueError(
            f"a stream on a {mesh.num_devices}-device mesh carries one state "
            "per device (fleet_stream_init(..., mesh=mesh)); got "
            f"{type(state).__name__}"
        )


def _sharded_step(step_local, state: Shards, step, config, mesh):
    """One streaming tick over ``mesh``: the tick's rows are split over the
    shards, each shard's state advances in place on its device, and the
    shards' attributions are joined on the first device.  The counters
    advance identically in every shard."""
    _check_shards(state, mesh)
    outs = [
        step_local(st, sp, config) for st, sp in zip(state, mesh.split(step))
    ]
    return Shards(o[0] for o in outs), mesh.join([o[1] for o in outs])


def _sharded_reset(reset_local, state: Shards, reset, x0, mesh) -> Shards:
    """The slot reset over ``mesh``: the flags and X_0 rows are split with
    the node axis, so each shard rewrites only its own slot block."""
    _check_shards(state, mesh)
    return Shards(
        reset_local(st, r, x) for st, (r, x) in zip(state, mesh.split((reset, x0)))
    )
