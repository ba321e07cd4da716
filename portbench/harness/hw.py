"""The card's published peaks and the roofline bound (a frozen copy of
``chip_smoke.py``'s ``bound``).

NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: HBM at
3.35 TB/s; 67 TFLOP/s in float32 outside the tensor cores (TF32 would
round) and in float64 on them (DMMA); 989 TFLOP/s in bf16. A card set below
700 W runs slower under load: the run prints its power limit beside every
share of these peaks.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}


def bound_s(bytes_moved: float, flops: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the dtype's peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
