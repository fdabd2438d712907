"""Build and load the hand-written CUDA kernels: one ``nvcc`` + ``ctypes`` path.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  It
is compiled for ``sm_90a`` at first use into ``kernels/build/`` as
``<name>_<hash>.so``, where the hash covers the source, the shared headers
and the flags, so an edited source is rebuilt and an unchanged one is not.
The library is
written under a temporary name and renamed into place, so a concurrent
build never loads a partial file.  Nothing is compiled or loaded at import
time: the CPU tests import every kernel module on machines with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}  # one handle per library and process
_sms: dict[int, int] = {}  # device index -> SM count


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def compile_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns nvcc's
    output (registers, shared memory and spills from ``-Xptxas -v``), or ""
    when nothing was compiled."""
    src = CSRC_DIR / f"{name}.cu"
    lib_path = library_path(name)
    if lib_path.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never loads a partial file
    return proc.stdout + proc.stderr


def load_library(name: str) -> tuple[ctypes.CDLL, str]:
    """The loaded library of ``csrc/<name>.cu``, compiling it if needed, and
    nvcc's output ("" when it was already built or loaded)."""
    if name in _loaded:
        return _loaded[name], ""
    log = compile_library(name)
    lib = ctypes.CDLL(str(library_path(name)))
    _loaded[name] = lib
    return lib, log


def compile_all(names: list[str]) -> dict[str, tuple[str, float]]:
    """Compile several kernels at once, one ``nvcc`` process each, all
    started together.  Returns each one's nvcc output and the seconds its
    build took."""

    def timed(name: str) -> tuple[str, float]:
        t0 = time.perf_counter()
        return compile_library(name), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a nonzero
    ``cudaGetLastError()``: a refused launch never runs, and a later
    ``torch.cuda.synchronize()`` would not report it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def kernel_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernels' vector loads
    need: a copy only when the tensor is a strided view or starts off an
    aligned address (torch's own allocations are aligned)."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: cannot align a {tuple(x.shape)} tensor to 16 bytes")
    return x


def sm_count(dev: torch.device) -> int:
    """SM count of a CUDA device, read once per process (the kernels' plans
    size their grids by it)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def stream_of(x: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream
