"""The card's own energy counter, read through NVML with ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card has
used since the driver was loaded.  The card is found by its UUID, as
``torch.cuda`` reports it, so the counter read is the one of the card the
run uses.  Nothing here falls back: without the library or the card, the
reader raises.
"""

from __future__ import annotations

import ctypes

import torch


class EnergyCounter:
    """Joules used by one CUDA device, from NVML's total-energy counter."""

    def __init__(self, device: torch.device):
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"the energy counter reads a CUDA card; none for device {device}")
        try:
            self._nvml = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as err:
            raise RuntimeError(f"cannot load NVML (libnvidia-ml.so.1): {err}") from err
        nvml = self._nvml
        nvml.nvmlInit_v2.restype = ctypes.c_int
        nvml.nvmlDeviceGetHandleByUUID.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        nvml.nvmlDeviceGetHandleByUUID.restype = ctypes.c_int
        nvml.nvmlDeviceGetTotalEnergyConsumption.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        nvml.nvmlDeviceGetTotalEnergyConsumption.restype = ctypes.c_int
        nvml.nvmlShutdown.restype = ctypes.c_int
        self._check(nvml.nvmlInit_v2(), "nvmlInit_v2")
        uuid = "GPU-" + str(torch.cuda.get_device_properties(device).uuid)
        self._handle = ctypes.c_void_p()
        self._check(nvml.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.byref(self._handle)),
                    f"nvmlDeviceGetHandleByUUID({uuid})")
        self.read()

    @staticmethod
    def _check(code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(f"NVML {what} returned error {code}")

    def read(self) -> float:
        """The counter, in joules."""
        mj = ctypes.c_ulonglong()
        self._check(self._nvml.nvmlDeviceGetTotalEnergyConsumption(self._handle, ctypes.byref(mj)),
                    "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value * 1e-3

    def close(self) -> None:
        self._check(self._nvml.nvmlShutdown(), "nvmlShutdown")
