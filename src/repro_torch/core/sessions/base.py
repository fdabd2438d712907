"""FleetSession: the common base of the live session layer.

Holds what every session over the streaming engine needs — the engine
package handle, the resolved ``EngineConfig`` — and the diagnostics of the
port's stream contract, which stand in for the reference's retrace counts
(``compile_counts``, which has no meaning without a jit cache): the number
of ticks dispatched, and the storage of every carried engine buffer, which
``fleet_step`` updates in place and which must not move during a stream.
"""

from __future__ import annotations

from repro_torch.core import engine as eng
from repro_torch.core.engine.segment import _NO_MESH

_NO_SLOTS = (
    "slots= (the slot-pool serving mode) is not ported yet: ROADMAP Queue 1 "
    "item 8 (elastic serving)"
)


class FleetSession:
    """Base class for live fleet sessions over the streaming engine.

    Subclasses own their engine state and expose it via ``state``; they
    count each ``fleet_step`` they dispatch in ``ticks_dispatched``.  With
    ``mesh`` (node-axis sharding) unported, a non-None mesh raises.
    """

    def __init__(self, *, config: "eng.EngineConfig | None", mesh=None):
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
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
        (Kalman leaves as ``kalman.<field>``).  Snapshot before and after a
        stream: the in-place contract says they never change."""
        st = self.state
        ptrs = {f"kalman.{k}": v.data_ptr() for k, v in st.kalman._asdict().items()}
        for k in ("c_buf", "w_buf", "a", "lat_sum", "lat_sumsq"):
            ptrs[k] = getattr(st, k).data_ptr()
        return ptrs
