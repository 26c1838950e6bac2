# Ported from tpurag/memory/freshness.py.
"""Memory freshness scoring, vectorized.

Reference formula (src/lib/memory/freshness.ts:20-23,37-56):

    score = confidence * exp(-decay_rate * hours_since_access)
                       * (1 + freq_bonus * ln(access_count + 1))
    clamped to [0, 1];  decay_rate=0.05/h (half-life ~14h), freq_bonus=0.1.

The reference computes this per memory in JS at query time; here it is
one elementwise transform over the whole candidate batch. Wall-clock
timestamps are passed in as arrays so the computation stays pure
(SURVEY.md §7.3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpurag_torch.core.config import FreshnessConfig


def freshness_scores(confidence, last_accessed_at, access_count, now: float,
                     config: FreshnessConfig | None = None, device="cuda"):
    """Batch freshness scores, (M,) float32 on `device`.

    confidence (M,) floats; last_accessed_at (M,) unix seconds;
    access_count (M,) ints or floats; now: current unix seconds (passed
    in, not read, to keep this pure)."""
    cfg = config or FreshnessConfig()
    # Subtract in float64 on the host: unix-epoch seconds exceed fp32
    # integer resolution (~64 s at 1.7e9), so an fp32 subtraction would
    # quantize ages.
    hours = np.maximum(
        now - np.asarray(last_accessed_at, np.float64), 0.0) / 3600.0
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=device)
    score = (f32(confidence)
             * torch.exp(-f32(cfg.decay_rate_per_hour) * f32(hours))
             * (1.0 + f32(cfg.freq_bonus) * torch.log(f32(access_count)
                                                      + 1.0)))
    return torch.clamp(score, 0.0, 1.0)


def combined_memory_scores(relevance, freshness,
                           relevance_weight: float = 0.7,
                           freshness_weight: float = 0.3, device="cuda"):
    """0.7 * relevance + 0.3 * freshness (src/lib/memory/store.ts:160),
    float32 on `device`."""
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=device)
    return (relevance_weight * f32(relevance)
            + freshness_weight * f32(freshness))
