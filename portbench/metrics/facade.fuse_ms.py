"""Host ms a batch in the program's `fuse` span: the score floor, the
keyword gate with the queries' idf mass, and reciprocal-rank fusion."""

from portbench import progspans


def read(run):
    p = progspans.placed(run)
    return p.span_ms("fuse") if p is not None else None
