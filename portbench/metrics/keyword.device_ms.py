"""Device ms a batch of the operations launched inside
InvertedIndex.search (K2; K3 and K4 on wide terms; their table copies)."""

SPANS = {"keyword": ("inverted.search",)}


def read(run):
    return run.trace.device_ms("keyword") if run.trace else None
