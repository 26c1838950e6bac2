"""The 95th percentile of the same samples as batch_p50_ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.call_s, 95)) * 1e3 if run.call_s else None
