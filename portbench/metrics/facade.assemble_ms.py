"""Host ms a batch in the program's `assemble` span: every query's
response built from the chunk store, highlighting included."""

from portbench import progspans


def read(run):
    p = progspans.placed(run)
    return p.span_ms("assemble") if p is not None else None
