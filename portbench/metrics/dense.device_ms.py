"""Device ms a batch of the operations launched inside the dense leg:
DenseIndex.search (K1; on an int8 KB K5 and K8's rescore) or, in mode
hybrid_ivf, IVFIndex.search (K6 and K8's rescore), with their torch glue
and the query's copy to the card."""

SPANS = {"dense": ("dense.search", "_ivf.search")}


def read(run):
    return run.trace.device_ms("dense") if run.trace else None
