"""Fleet-axis sharding: the B-node axis of the engines over a list of devices.

The port of the reference's ``FleetMesh`` (``repro/distributed/sharding.py``,
its fleet-axis part).  The reference shards with ``shard_map`` over a 1-D
JAX ``Mesh``; here a sharded tree is a ``Shards`` tuple holding one tree
per mesh device, each with that device's contiguous block of B / n nodes
on its leading axis, and the engines run their unsharded local function on
each shard in turn from one host thread (``core.engine.sharding``).  CUDA
launches return before the work is done, so shards on separate cards
overlap.  Per-node math needs no communication; the one cross-shard
reduction is ``fleet_attribution_totals`` (the reference's ``psum``).

Two departures from the reference, both recorded in ROADMAP Queue 3:

- a mesh may repeat a device (``fleet_mesh(devices=["cpu"] * 4)``): JAX's
  ``Mesh`` refuses that, but it is how the split, join and totals logic runs
  on a machine with one device.  It measures no scaling;
- host scalars (the stream's ``tick_in_step`` / ``step_idx`` counters, a
  tick's ``step_completed``) are plain Python values, copied into every
  shard as the reference replicates its rank-0 leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

#: Name of the fleet's node axis.
FLEET_AXIS = "node"


class Shards(tuple):
    """One tree per device of a ``FleetMesh``, in mesh order: shard ``i``
    holds the i-th contiguous block of the node axis, on device ``i``."""


def _is_leaf_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor (or numpy array) leaf of a tree of
    NamedTuples, tuples and lists; ``None`` and host scalars pass through
    unchanged."""
    if _is_leaf_array(tree):
        return fn(torch.as_tensor(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def _join(parts: list, device: torch.device):
    """Concatenate matching trees along their leading axis onto ``device``
    (one part is returned as it is); host scalars are taken from the first
    part, where every shard holds the same value."""
    first = parts[0]
    if len(parts) == 1:
        return first
    if isinstance(first, torch.Tensor):
        if first.ndim == 0:
            return first.to(device)
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_join([p[i] for p in parts], device) for i in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(_join([p[i] for p in parts], device) for i in range(len(first)))
    return first


def _first_device(tree) -> torch.device | None:
    found: list[torch.device] = []
    _tree_map(lambda t: found.append(t.device) or t, tree)
    return found[0] if found else None


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D device mesh over the fleet's node (B) axis.

    Frozen and hashable, like the reference's.  The node axis is the
    outermost dimension of every fleet tensor (``FleetInputs``,
    ``FleetStreamState`` buffers, ``FleetResult`` leaves); device ``i`` of
    the ``num_devices`` owns the i-th contiguous block of ``B / num_devices``
    nodes.  A device may appear more than once.
    """

    devices: tuple
    axis: str = FLEET_AXIS

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a FleetMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def num_devices(self) -> int:
        """Devices along the node axis."""
        return len(self.devices)

    def validate(self, num_nodes: int) -> None:
        """Reject fleets whose node count does not tile the mesh evenly."""
        if num_nodes % self.num_devices != 0:
            raise ValueError(
                f"fleet of {num_nodes} node(s) is not divisible by the "
                f"{self.num_devices}-device '{self.axis}' mesh; pad the fleet "
                f"or build the mesh with fleet_mesh(num_nodes={num_nodes})"
            )

    def split(self, tree) -> list:
        """``tree`` cut into one tree per device: every tensor leaf of rank
        >= 1 is cut into contiguous blocks along its leading axis (which
        must tile the mesh), each moved to its device; rank-0 tensors are
        copied to every device, and ``None`` and host scalars pass through.
        A block on the device it already lies on is a view, not a copy."""
        n = self.num_devices

        def block(i):
            dev = self.devices[i]

            def cut(t):
                if t.ndim == 0:
                    return t.to(dev)
                self.validate(t.shape[0])
                size = t.shape[0] // n
                return (t if n == 1 else t[i * size : (i + 1) * size]).to(dev)

            return _tree_map(cut, tree)

        return [block(i) for i in range(n)]

    def join(self, parts: Sequence) -> Any:
        """The per-device trees ``parts`` concatenated along the node axis
        on the mesh's first device (a one-device mesh returns its one part
        as it is, with no copy)."""
        return _join(list(parts), self.devices[0])

    def put(self, tree: Any) -> Shards:
        """Place a tree on the mesh: a ``Shards`` of ``split(tree)``
        (``join`` is its inverse)."""
        return Shards(self.split(tree))

    def specs_like(self, tree: Any) -> Any:
        """Per-leaf placement, the torch equivalent of the reference's
        ``PartitionSpec`` tree: ``axis`` for a leaf split over the nodes,
        ``None`` for one copied to every device (rank-0 tensors, host
        scalars)."""
        if _is_leaf_array(tree):
            return self.axis if np.ndim(tree) > 0 else None
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(self.specs_like(x) for x in tree))
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.specs_like(x) for x in tree)
        return None


def _visible_cuda() -> list[str]:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def fleet_mesh(
    num_nodes: int | None = None,
    *,
    devices: Sequence[Any] | None = None,
    axis: str = FLEET_AXIS,
) -> FleetMesh:
    """Build a ``FleetMesh`` over ``devices`` (default: every visible CUDA
    device; raises when there is none).

    With ``num_nodes`` the mesh uses the *largest* leading run of the
    devices whose length divides the fleet, so an awkward fleet size gets
    fewer devices instead of failing.  The one-device mesh is the identity
    sharding: every ``mesh=`` path gives the mesh=None result bit for bit.
    """
    devs = list(_visible_cuda() if devices is None else devices)
    if not devs:
        raise RuntimeError("fleet_mesh: no CUDA device is visible; pass devices=")
    d = len(devs)
    if num_nodes is not None:
        while d > 1 and num_nodes % d != 0:
            d -= 1
    return FleetMesh(devices=tuple(devs[:d]), axis=axis)


def fleet_mesh_auto(num_nodes: int) -> FleetMesh | None:
    """``fleet_mesh`` for controllers: None unless sharding actually helps.

    Returns a mesh only when more than one CUDA device is visible *and* the
    fleet divides onto more than one of them; ``profile_fleet(mesh="auto")``
    uses this, so a one-card deployment keeps the unsharded path.
    """
    if torch.cuda.device_count() <= 1:
        return None
    fm = fleet_mesh(num_nodes)
    return fm if fm.num_devices > 1 else None


def reshard(tree: Any, mesh: FleetMesh | None = None, *, device=None) -> Any:
    """Re-place a live tree onto a (new) mesh mid-stream: mesh elasticity.

    Every leaf is copied to the host (the checkpoint; a ``Shards`` tree is
    joined there first) and placed again: split over ``mesh``, or, with
    ``mesh=None``, whole on ``device`` (default: the device the tree's first
    tensor lies on).  The values keep their bits; only where they live
    changes.
    """
    if device is None:
        device = _first_device(tree)
    host_copy = lambda t: t.to("cpu", copy=True)  # noqa: E731
    if isinstance(tree, Shards):
        host = _join([_tree_map(host_copy, s) for s in tree], torch.device("cpu"))
    else:
        host = _tree_map(host_copy, tree)
    if mesh is not None:
        return mesh.put(host)
    return _tree_map(lambda t: t.to(device), host)


class FleetTotals(NamedTuple):
    """Fleet-wide conserved-attribution totals (one controller-level view).

    ``per_fn.sum() + unattributed == attributed + unattributed`` equals the
    fleet's total measured active power-ticks.  Combined mode (§4.3) keeps
    the chip and 'rest' sides apart: ``per_fn``/``attributed`` cover the
    disaggregated rest power, ``chip_per_fn``/``chip_total`` the counter
    model's X_CPU (zeros in pure mode).
    """

    per_fn: torch.Tensor        # (M,) attributed power summed over nodes and ticks (W)
    attributed: torch.Tensor    # ()   total attributed power-ticks across the fleet
    unattributed: torch.Tensor  # ()   total unattributed power-ticks across the fleet
    cp_total: torch.Tensor      # ()   control-plane power summed over nodes (0 if absent)
    chip_per_fn: torch.Tensor   # (M,) counter-model chip power summed over nodes (W)
    chip_total: torch.Tensor    # ()   fleet chip-side total (0 in pure mode)


def _part(tp, ua, cpv, m, chip) -> FleetTotals:
    """Node-local (one shard's) totals; ``m`` is the tick mask or None,
    ``chip=None`` fills zeros."""
    if m is not None:
        tp = tp * m[..., None]
        ua = ua * m
    n_fns = tp.shape[-1]
    return FleetTotals(
        per_fn=tp.sum(dim=(0, 1)),
        attributed=tp.sum(),
        unattributed=ua.sum(),
        cp_total=cpv.sum(),
        chip_per_fn=tp.new_zeros((n_fns,)) if chip is None else chip.sum(dim=0),
        chip_total=tp.new_zeros(()) if chip is None else chip.sum(),
    )


def fleet_attribution_totals(
    tick_power: torch.Tensor,                # (B, T, M) conserved per-tick power
    unattributed: torch.Tensor,              # (B, T)
    cp_power: torch.Tensor | None = None,    # (B,) per-node control-plane power
    *,
    chip_power: torch.Tensor | None = None,  # (B, M) per-node per-function X_CPU (§4.3)
    mask: torch.Tensor | None = None,        # (B, T) tick validity for ragged fleets
    mesh: FleetMesh | None = None,
) -> FleetTotals:
    """Reduce per-node attribution to fleet totals (the reference's ``psum``).

    Unsharded this is a handful of sums.  With a ``FleetMesh`` every input
    is split over the node axis, each shard reduces its own node block on
    its device, and the partials are summed in shard order on the mesh's
    first device: the only cross-shard step of the sharded controller.
    ``mask`` excludes padded ticks from every total before the reduction;
    ``chip_power`` rides the same reduction into ``chip_per_fn`` /
    ``chip_total``.
    """
    cp = (
        tick_power.new_zeros((tick_power.shape[0],)) if cp_power is None else cp_power
    )
    if mask is not None:
        mask = mask.reshape(unattributed.shape).to(tick_power.dtype)
    if mesh is None:
        return _part(tick_power, unattributed, cp, mask, chip_power)
    mesh.validate(tick_power.shape[0])
    parts = [
        _part(*args)
        for args in mesh.split((tick_power, unattributed, cp, mask, chip_power))
    ]
    dev = mesh.devices[0]
    total = FleetTotals(*(v.to(dev) for v in parts[0]))
    for p in parts[1:]:
        total = FleetTotals(*(a + b.to(dev) for a, b in zip(total, p)))
    return total
