"""Host ms a batch in the program's `fetch` span: the host copy of the
fused (scores, ids, bits), where the host waits on the device."""

from portbench import progspans


def read(run):
    p = progspans.placed(run)
    return p.span_ms("fetch") if p is not None else None
