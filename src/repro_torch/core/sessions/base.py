"""FleetSession: the common base of the live session layer.

Both concrete sessions — the telemetry-level ``StreamingFleetSession``
(whole profiling segments, window by window) and the engine-level
``SlotFleetSession`` (a slot pool with continuous admission and retirement)
— drive the same streaming engine and share its operational contract: an
engine config, an optional ``FleetMesh``, and the diagnostics that stand in
for the reference's retrace counts (``compile_counts``, which has no
meaning without a jit cache): the number of ticks dispatched, and the
storage of every carried engine buffer, which ``fleet_step`` updates in
place and which must not move during a stream.
"""

from __future__ import annotations

import torch

from repro_torch.core import engine as eng
from repro_torch.distributed.sharding import Shards


def _pointers(st) -> dict[str, int]:
    ptrs = {f"kalman.{k}": v.data_ptr() for k, v in st.kalman._asdict().items()}
    for k in ("c_buf", "w_buf", "a", "lat_sum", "lat_sumsq"):
        ptrs[k] = getattr(st, k).data_ptr()
    return ptrs


class FleetSession:
    """Base class for live fleet sessions over the streaming engine.

    Holds the engine package handle, the resolved ``EngineConfig`` and the
    optional ``FleetMesh``.  Subclasses own their engine state and expose it
    via ``state`` (a ``Shards`` tuple, one state per mesh device, when
    sharded); they count each ``fleet_step`` they dispatch in
    ``ticks_dispatched``.
    """

    def __init__(self, *, config: "eng.EngineConfig | None", mesh=None):
        self.eng = eng
        self.config = config
        self.mesh = mesh
        self.ticks_dispatched = 0

    @property
    def state(self):
        """Live engine state (``FleetStreamState``); subclass-owned."""
        raise NotImplementedError

    def buffer_pointers(self) -> dict[str, int]:
        """``data_ptr()`` of every carried tensor of the live engine state
        (Kalman leaves as ``kalman.<field>``; on a mesh, every shard's,
        prefixed ``<shard>/``).  Snapshot before and after a stream: the
        in-place contract says they never change."""
        st = self.state
        if isinstance(st, Shards):
            return {f"{i}/{k}": v for i, s in enumerate(st) for k, v in _pointers(s).items()}
        return _pointers(st)

    def engine_x(self) -> torch.Tensor:
        """(B, M) current Kalman estimate of the engine state, in state row
        order, as a fresh tensor (joined on the mesh's first device when
        sharded)."""
        st = self.state
        if isinstance(st, Shards):
            return self.mesh.join([s.kalman.x for s in st]).clone()
        return st.kalman.x.clone()
