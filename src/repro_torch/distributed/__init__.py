"""Distribution over devices: the fleet's node axis over a ``FleetMesh``.

``sharding`` holds the fleet-axis part of the reference's
``distributed/sharding.py``: ``FleetMesh`` and ``fleet_mesh`` /
``fleet_mesh_auto`` to build one, ``reshard`` to move a live tree to another
mesh, and ``fleet_attribution_totals``, the one cross-shard reduction.
``checkpoint`` is the reference's checkpointing on its on-disk layout
(atomic commit, async save, retention, restore onto a device).  The model
zoo's logical-axis rules and the collectives are not ported yet (ROADMAP
Queue 1 item 9.8).
"""

from repro_torch.distributed.sharding import (
    FLEET_AXIS,
    FleetMesh,
    FleetTotals,
    Shards,
    fleet_attribution_totals,
    fleet_mesh,
    fleet_mesh_auto,
    reshard,
)

__all__ = [
    "FLEET_AXIS",
    "FleetMesh",
    "FleetTotals",
    "Shards",
    "fleet_attribution_totals",
    "fleet_mesh",
    "fleet_mesh_auto",
    "reshard",
]
