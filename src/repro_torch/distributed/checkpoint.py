"""Async checkpointing with a crash-safe commit -- the twin of the
reference's ``repro/distributed/checkpoint.py``, on its on-disk layout, so
a checkpoint written by either package restores into the other::

    <dir>/step_00000420/
        manifest.json      # step, leaf index (shape, dtype, file, key), "complete"
        shard_000_000.npz  # leaf arrays, a new file every ~512 MB

Leaves are named by the reference's ``jax.tree_util.keystr`` paths
(``.params['layers']['attn']['wq']``, ``.opt.count``); a state's per-layer
lists are stacked back into the reference's (L, ...) arrays on save and
split into the per-layer tensors on restore (``models.common.leaf_groups``).

- **Atomic commit**: everything is written into ``<dir>/.tmp-ckpt-...`` and
  renamed into place; the manifest (with ``complete: true``) is written
  last, so a crash mid-save never leaves a checkpoint that ``latest_step``
  picks up, and ``restore_latest`` falls back past a damaged one.
- **Async**: ``CheckpointManager.save`` copies the state to host memory
  synchronously (the train step updates the state in place right after)
  and writes on a background thread; one save is in flight at a time.
  The shard files are written, and read back, by a pool of threads
  (``np.savez``'s CRC and the file I/O release the GIL; a full-width
  internlm2-1.8b state is 22.7 GB in 45 shards), and ``chip_smoke.py``'s
  training phase prints the save and restore times.
- **Restore onto a device**: ``restore_checkpoint`` reads and checks every
  leaf on the host first, then copies each into the target's own tensors
  (on whatever device they live; a ``DTensor`` leaf takes its own block),
  so a damaged checkpoint leaves the target untouched and a restore needs
  no second copy of the state on the card.
- **Elastic re-shard**: leaves are stored whole, so ``shardings=`` (a
  ``NamedSharding`` tree, ``train_step.state_shardings``) places the
  restored state onto any mesh, whatever mesh wrote it: a one-device mesh
  keeps plain tensors, a larger one ``DTensor``s of each rank's block.
- **A placed state** (``DTensor`` leaves) is gathered whole for a save
  (``full_tensor``, a collective every rank joins) and written by process
  0 alone, so it gives the same files, leaf names and bytes as the save of
  the same state unplaced; a blocking save ends at a barrier.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import local_block, place_tree
from repro_torch.models.common import leaf_groups

_MANIFEST = "manifest.json"
_SHARD_BYTES = 512 * 1024 * 1024  # flush a shard file at ~512 MB
_IO_THREADS = min(8, os.cpu_count() or 1)


def _host(leaves: list, stacked: bool) -> np.ndarray:
    """A host copy (never a view: the step updates the state in place next)."""
    if all(isinstance(x, torch.Tensor) for x in leaves):
        with torch.no_grad():
            leaves = [x.full_tensor() if isinstance(x, DTensor) else x for x in leaves]
            x = torch.stack(leaves) if stacked else leaves[0].clone()  # copied where the leaves live
            return x.cpu().numpy()
    return np.stack([np.asarray(x) for x in leaves]) if stacked else np.array(leaves[0])


def host_arrays(state: Any) -> dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host numpy array under its reference
    path, per-layer lists stacked, in the reference's order."""
    return {name: _host(leaves, stacked) for name, leaves, stacked in leaf_groups(state)}


def _writer() -> bool:
    """Process 0 writes; every process of a group gathers."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _placed(state: Any) -> bool:
    return any(isinstance(x, DTensor) for _, leaves, _ in leaf_groups(state) for x in leaves)


def save_checkpoint(directory: str, step: int, state: Any, *, process_index: int = 0) -> str:
    """Write one checkpoint of ``state`` (tensors on any device, or placed)
    synchronously.  Returns the committed path."""
    arrays = host_arrays(state)
    path = os.path.join(directory, f"step_{step:08d}")
    if _writer():
        path = _write(directory, step, arrays, process_index)
    if _placed(state):
        dist.barrier()
    return path


def _write(directory: str, step: int, arrays: dict[str, np.ndarray], process_index: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp-ckpt-", dir=directory)
    try:
        index: dict[str, dict] = {}
        shards: list[dict] = [{}]
        shard_bytes = 0
        for i, (name, arr) in enumerate(arrays.items()):
            if shard_bytes >= _SHARD_BYTES:
                shards.append({})
                shard_bytes = 0
            key = f"leaf_{i:05d}"
            index[name] = {"file": f"shard_{process_index:03d}_{len(shards) - 1:03d}.npz", "key": key,
                           "shape": list(arr.shape), "dtype": str(arr.dtype)}
            shards[-1][key] = arr
            shard_bytes += arr.nbytes
        with concurrent.futures.ThreadPoolExecutor(_IO_THREADS) as pool:
            writes = [pool.submit(np.savez, os.path.join(tmp, f"shard_{process_index:03d}_{j:03d}.npz"), **buf)
                      for j, buf in enumerate(shards) if buf]
            for w in writes:
                w.result()
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": step, "complete": True, "index": index}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def list_steps(directory: str) -> list[int]:
    """Steps with a complete manifest, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            with open(os.path.join(directory, name, _MANIFEST)) as f:
                m = json.load(f)
            if m.get("complete"):
                steps.append(int(m["step"]))
        except (OSError, ValueError, KeyError):
            continue  # damaged / in-flight checkpoint: skip
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    """Newest checkpointed step under ``directory``, or None when empty."""
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, target: Any, *, shardings: Any = None) -> Any:
    """Restore ``step`` into ``target``'s own tensors and return it.

    Every leaf of ``target`` (a train state, or any tree of tensors) must
    be in the checkpoint with its shape (stacked (L, ...) for a per-layer
    list); all of them are read and checked before any is written, so a
    missing leaf, a wrong shape or an unreadable file (``KeyError``,
    ``ValueError``, ``OSError``) leaves ``target`` as it was.  Values are
    cast to each target tensor's dtype; a ``DTensor`` leaf takes its own
    block.  ``shardings`` (a matching tree of ``NamedSharding``, ``None``
    where a leaf stays as it is) then places the result on any mesh
    (``distributed.sharding.place_tree``).
    """
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise ValueError(f"checkpoint {path} is incomplete")
    index = manifest["index"]
    plan = []
    for name, leaves, stacked in leaf_groups(target):
        entry = index.get(name)
        if entry is None or entry.get("none"):
            raise KeyError(f"checkpoint missing leaf {name}")
        want = (len(leaves), *leaves[0].shape) if stacked else tuple(leaves[0].shape)
        if tuple(entry["shape"]) != want:
            raise ValueError(f"shape mismatch for {name}: ckpt {tuple(entry['shape'])} vs target {want}")
        plan.append((name, entry, leaves, stacked, want))
    with concurrent.futures.ThreadPoolExecutor(_IO_THREADS) as pool:
        reads = {f: pool.submit(_read_npz, os.path.join(path, f)) for f in {e["file"] for _, e, _, _, _ in plan}}
        files = {f: r.result() for f, r in reads.items()}
    loaded = []
    for name, entry, leaves, stacked, want in plan:
        arr = files[entry["file"]][entry["key"]]
        if arr.shape != want:  # the manifest and the array disagree: a damaged checkpoint
            raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} vs target {want}")
        loaded.append((leaves, arr if stacked else arr[None]))
    with torch.no_grad():
        for leaves, arr in loaded:
            for leaf, a in zip(leaves, arr):
                if isinstance(leaf, DTensor):
                    leaf.to_local().copy_(local_block(torch.as_tensor(a), leaf.device_mesh, leaf.placements))
                else:
                    leaf.copy_(torch.as_tensor(a))
    return place_tree(target, shardings)


def _read_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@dataclasses.dataclass
class CheckpointManager:
    """Async writer + retention policy + auto-resume."""

    directory: str
    keep: int = 3

    def __post_init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshot ``state`` to host memory now and write it (on a thread
        unless ``blocking``); a write error surfaces at the next ``save``
        or ``wait``."""
        self.wait()  # one in-flight save at a time
        arrays = host_arrays(state)
        placed = _placed(state)
        if not _writer():
            if blocking and placed:
                dist.barrier()
            return

        def write():
            try:
                _write(self.directory, step, arrays)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
            if placed:
                dist.barrier()
        else:
            self._thread = threading.Thread(target=write, daemon=True, name="checkpoint-writer")
            self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save and raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, target: Any, *, shardings: Any = None) -> tuple[int, Any] | None:
        """(step, target restored and placed on ``shardings``) from the
        newest valid checkpoint, or None.  Falls back through damaged
        checkpoints (crash-mid-save recovery)."""
        for step in reversed(list_steps(self.directory)):
            try:
                return step, restore_checkpoint(self.directory, step, target, shardings=shardings)
            except (OSError, ValueError, KeyError):
                continue
        return None

    def _gc(self) -> None:
        steps = list_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
