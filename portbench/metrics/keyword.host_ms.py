"""Host ms a batch inside InvertedIndex.search: width classing, slot
arrays and the kernels' enqueue."""

SPANS = {"keyword": ("inverted.search",)}


def read(run):
    return run.trace.host_ms("keyword") if run.trace else None
