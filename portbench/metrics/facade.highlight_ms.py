"""Host ms a batch of highlighting the keyword-found results, the
`highlight_ns` that the program's `assemble` span carries."""

from portbench import progspans


def read(run):
    p = progspans.placed(run)
    return p.attr_ms("assemble", "highlight_ns") if p is not None else None
