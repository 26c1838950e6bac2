"""Median over the window's calls of the host clock around
KnowledgeBase.search_batch (the call ends in the results' host copy and
the assembled responses)."""

import numpy as np


def read(run):
    return float(np.percentile(run.call_s, 50)) * 1e3 if run.call_s else None
