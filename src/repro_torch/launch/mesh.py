"""The launchers' meshes -- the twin of the reference's
``repro/launch/mesh.py`` -- and the H100's device constants.

Functions, not module constants: importing this module touches no device
and starts no process group.  A torch mesh is a ``DeviceMesh`` over the
ranks of the default process group, one process per card:

- ``make_production_mesh`` gives the reference's pod (16, 16) ("data",
  "model") or multipod (2, 16, 16) ("pod", "data", "model").  It needs a
  group of exactly 256 or 512 ranks and raises otherwise, naming the count
  (``jax.make_mesh`` raises there too); nothing falls back to a smaller
  mesh.
- ``make_local_mesh`` gives (n, 1) ("data", "model") over the group's n
  ranks: n = 1 on a one-card machine, where ``process_group`` makes a
  one-rank group in the process when none exists.

``fake_process_group(n)`` makes a world of n ranks that exchanges nothing
(torch's fake backend; this process is rank 0), so that the production
meshes can be built on one machine with no card for a trace on fake
tensors (``launch.dryrun``).

The device constants are the H100's: the reference's TPU figures do not
carry over.  The peaks are NVIDIA's datasheet figures for the H100 SXM5;
the idle and dynamic power were measured on an NVIDIA H100 80GB HBM3 at a
700.00 W power limit (``chip_smoke.py``'s idle-power line: the median of
ten ``nvidia-smi --query-gpu=power.draw,power.limit`` samples at rest), and
``HBM_BYTES`` is that card's ``torch.cuda.get_device_properties(0).
total_memory``.  ``LINK_BW`` is the roofline's collective denominator:
both axes of the (16, 16) pod span nodes of 8 cards, so every exchange
crosses the inter-node network, and the figure is one card's InfiniBand
port, not its NVLink (``NVLINK_BW`` reaches only the 8 cards of a node).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

#: (shape, axis names) of the reference's production meshes.
_PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 cards per pod; 2 pods = 512 cards multi-pod.  Raises
    ``RuntimeError`` unless the process group has exactly that many ranks."""
    shape, axes = _PRODUCTION[multi_pod]
    need, have = math.prod(shape), _world_size()
    if have != need:
        raise RuntimeError(f"the {'multipod' if multi_pod else 'pod'} mesh {shape} {axes} needs {need} ranks, "
                           f"one per card; this process group has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type: str = "cuda"):
    """(n, 1) ("data", "model") over the process group's n ranks."""
    return init_device_mesh(device_type, (_world_size(), 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks on torch's fake
    backend, this process rank 0: collectives return at once and move
    nothing.  Refuses to start inside an initialised group (the fake world
    does not nest) and destroys its group on exit."""
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already initialised; the fake world cannot nest "
                           "inside it")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device_type: str = "cuda"):
    """The default process group for a launcher's mesh: the one already
    initialised, or else a one-rank group made here on an in-process store
    (NCCL on the card, gloo on the CPU) and destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# NVIDIA H100 SXM5 constants (roofline denominators, the telemetry model).
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s per card (NVIDIA datasheet)
HBM_BW = 3.35e12              # bytes/s per card (NVIDIA datasheet)
NVLINK_BW = 900e9             # bytes/s per card over its 18 NVLink-4 links, both directions (NVIDIA datasheet)
LINK_BW = 50e9                # bytes/s per card between nodes: one 400 Gb/s NDR InfiniBand port (ConnectX-7) per
                              # GPU, each direction (NVIDIA DGX H100 datasheet: 8 ports of 400 Gb/s for 8 GPUs)
ICI_LINK_BW = LINK_BW         # the reference's name for the roofline's collective link: a TPU's inter-chip link;
                              # a pod of H100s spans nodes, so its twin is the per-card inter-node port above
HBM_BYTES = 85_017_493_504    # device memory per card (H100 80GB HBM3, 700.00 W limit; measured total_memory)
CHIP_IDLE_W = 69.97           # W drawn at rest (H100 80GB HBM3, 700.00 W limit; measured)
CHIP_DYN_W = 630.03           # W above idle at the power limit: 700.00 - 69.97
