"""Distribution over devices: the logical-axis sharding rules, the
fleet's node axis over a ``FleetMesh``, the collectives and checkpoints.

``sharding`` holds both halves of the reference's
``distributed/sharding.py``: the model zoo's logical-axis rules
(``TRAIN_RULES``, ``SERVE_RULES``, ``EP_RULES``, ``ZERO3_RULES``,
``spec_for``, ``sharding_for`` onto DTensor placements, ``use_rules`` and
``shard_activation``, and ``place`` / ``place_tree`` to put tensors on a
mesh), and ``FleetMesh`` / ``fleet_mesh`` / ``fleet_mesh_auto``,
``reshard`` and ``fleet_attribution_totals`` for the fleet's node axis.
``collectives`` is the int8 compressed all-reduce over the "pod" axis.
``checkpoint`` is the reference's checkpointing on its on-disk layout
(atomic commit, async save, retention, restore onto a device, re-shard
onto a mesh).
"""

from repro_torch.distributed.sharding import (
    EP_RULES,
    FLEET_AXIS,
    SERVE_RULES,
    TRAIN_RULES,
    ZERO3_RULES,
    FleetMesh,
    FleetTotals,
    Shards,
    fleet_attribution_totals,
    fleet_mesh,
    fleet_mesh_auto,
    reshard,
    shard_activation,
    sharding_for,
    spec_for,
    use_rules,
)

__all__ = [
    "EP_RULES",
    "FLEET_AXIS",
    "SERVE_RULES",
    "TRAIN_RULES",
    "ZERO3_RULES",
    "FleetMesh",
    "FleetTotals",
    "Shards",
    "fleet_attribution_totals",
    "fleet_mesh",
    "fleet_mesh_auto",
    "reshard",
    "shard_activation",
    "sharding_for",
    "spec_for",
    "use_rules",
]
