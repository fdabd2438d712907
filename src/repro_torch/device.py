"""Device resolution shared by every public entry point of the port.

An entry point takes ``device=`` (default ``"cuda"``).  Asking for CUDA on
a machine without it raises instead of quietly running on the CPU, so a
measurement can never be taken on the wrong device by accident; the CPU
tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """Return ``torch.device(device)``, raising if it names CUDA and none is
    present.

    On CUDA it also switches TF32 off for float32 matmuls and convolutions:
    the engine's float32 contractions must stay full precision to hold the
    port to the reference at 1e-5 (TF32 keeps about three decimal digits).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
