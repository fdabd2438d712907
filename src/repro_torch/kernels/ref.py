"""Plain PyTorch versions of the hand-written kernels.

The CPU path and the tests run these; ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.  Nothing on the main path
calls them for a CUDA tensor.
"""

from __future__ import annotations

import torch


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal-equation assembly for the disaggregation solve (paper Eq. 1).

    Args:
      c: (..., N, M) contribution windows; w: (..., N) power targets.
    Returns:
      gram (..., M, M) = C^T C and rhs (..., M) = C^T W in fp32.
    """
    c32 = c.to(torch.float32)
    w32 = w.to(torch.float32)
    gram = torch.einsum("...nm,...nk->...mk", c32, c32)
    rhs = torch.einsum("...nm,...n->...m", c32, w32)
    return gram, rhs
