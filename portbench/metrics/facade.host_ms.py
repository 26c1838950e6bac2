"""Host ms a batch in KnowledgeBase.search_batch outside the keyword and
dense legs' spans: locks, the keyword gate's idf mass, fusion's launches,
the results' host copy and the assembly of the responses."""

SPANS = {"keyword": ("inverted.search",),
         "dense": ("dense.search", "_ivf.search")}


def read(run):
    return run.trace.self_host_ms() if run.trace else None
