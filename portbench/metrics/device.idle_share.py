"""Share of the profiled slice's wall time in which no device operation
ran: 100 (1 - busy / wall), busy the union of the operations' intervals."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
