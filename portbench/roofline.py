"""Published peaks of one NVIDIA H100 (SXM, dense, at its 700 W limit) and
the least time of a layer's work, counted from shapes.

``bound_ms`` and the peaks are copies of chip_smoke.py's; the peaks are
NVIDIA's data sheet's.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
              "float8": 1979e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    """(least ms, what bounds it): bytes over 3.35 TB/s, or operations
    over `peak_ops` per second, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_exact_ms(b: int, n: int, d: int, dtype: str = "bfloat16"):
    """The least time of an exact dense scan of b queries over n rows of
    width d: 2 b n d operations at the dtype's rate, or each corpus and
    query element read once, whichever bounds it."""
    size = BYTES[dtype]
    return bound_ms(n * d * size + b * d * size, 2.0 * b * n * d,
                    PEAK_FLOPS[dtype])
