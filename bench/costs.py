"""The benchmark's yardstick of work: the FLOPs and bytes of a matrix
product and of the flash attention ops, and the card's peaks.  A model's
FLOPs are its family's (``bench/families/<family>.py``), composed into one
unit's by the driver of its traffic (``bench/drivers/<kind>.py``).

Frozen here, under the benchmark's own paths, so that a change to the
program cannot move the measure it is judged by.  The causal convention of
the attention scores (``2 x 2 x queries x keys x heads x d``, halved when
causal) is that of the FLOP formulas the port's ``kernels/ops.py``
registers.
"""

from __future__ import annotations

import math

#: Published peaks of one card (NVIDIA's data sheet, SXM part, dense, at a
#: 700 W limit): tensor-core bf16, fp32 outside the tensor cores (TF32
#: off), and HBM bandwidth.  Keyed by ``torch.cuda.get_device_name``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
}

#: Bytes of an element by the dtype names the profiler records.
ELEMENT_BYTES = {"c10::BFloat16": 2, "float": 4}

#: The profiler's dtype names -> the key of the compute peak.
PEAK_KEY = {"c10::BFloat16": "bf16", "float": "fp32"}

#: A configuration's compute dtype -> the key of the compute peak.
PEAK_KEY_OF_DTYPE = {"bfloat16": "bf16", "float32": "fp32"}


def attention_flops(b: int, s: int, t: int, heads: int, head_dim: int, causal: bool) -> float:
    """Score and value products of ``b x s`` queries against ``t`` keys."""
    return 2.0 * 2.0 * b * s * t * heads * head_dim / (2.0 if causal else 1.0)


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def product_work(name: str, shapes: list, dtypes: list) -> tuple[float, float, str] | None:
    """(FLOPs, bytes, dtype) of one matrix-product op from its recorded
    input shapes, each input byte read once and the output written once;
    None for an op or a layout it does not know."""
    key = name.split("::")[-1]
    try:
        if key in ("mm", "bmm"):
            a, b = shapes[0], shapes[1]
            batch = a[0] if key == "bmm" else 1
            m, k, n = a[-2], a[-1], b[-1]
            ins = [a, b]
            dt = dtypes[0]
        elif key == "addmm":
            c, a, b = shapes[0], shapes[1], shapes[2]
            batch = 1
            m, k, n = a[-2], a[-1], b[-1]
            ins = [c, a, b]
            dt = dtypes[1]
        else:
            return None
    except (IndexError, TypeError):
        return None
    if dt not in ELEMENT_BYTES:
        return None
    flops = 2.0 * batch * m * k * n
    nbytes = (sum(_numel(x) for x in ins) + batch * m * n) * ELEMENT_BYTES[dt]
    return flops, float(nbytes), dt


def flash_work(name: str, shapes: list, dtypes: list, causal: bool) -> tuple[float, float, str] | None:
    """(FLOPs, bytes, dtype) of a ``repro_torch::flash_attention*`` call:
    q (B, S, H, d) against k, v (B, T, Hkv, d).  The forward reads q, k, v
    and writes the output (and, for ``_lse``, an fp32 log-sum-exp a row);
    the backward's five products are 2.5 times the forward's two, and it
    reads q, k, v, out, dout and the fp32 log-sum-exp and writes dq, dk, dv."""
    key = name.split("::")[-1]
    q, k = shapes[0], shapes[1]
    if len(q) != 4 or len(k) != 4 or dtypes[0] not in ELEMENT_BYTES:
        return None
    b, s, h, d = q
    t, hkv = k[1], k[2]
    el = ELEMENT_BYTES[dtypes[0]]
    fwd = attention_flops(b, s, t, h, d, causal)
    qn, kn = b * s * h * d, b * t * hkv * d
    if key == "flash_attention":
        return fwd, float((2 * qn + 2 * kn) * el), dtypes[0]
    if key == "flash_attention_lse":
        return fwd, float((2 * qn + 2 * kn) * el + 4 * b * s * h), dtypes[0]
    if key == "flash_attention_bwd":
        return 2.5 * fwd, float((4 * qn + 4 * kn) * el + 4 * b * s * h), dtypes[0]
    return None


def bound_seconds(flops: float, nbytes: float, dtype: str, peaks: dict) -> float:
    """The least time the card could take: the larger of FLOPs over the
    compute peak of the dtype and bytes over the HBM bandwidth."""
    return max(flops / peaks[PEAK_KEY[dtype]], nbytes / peaks["hbm"])
