"""Share of the device's idle time inside the slice's calls that no
program span below the call's root covers (gc spans count): the idle time
the program's spans leave unexplained. The log lists the longest idle
stretches, each named by its innermost program span."""

from portbench import progspans


def read(run):
    p = progspans.placed(run)
    return p.idle_unattributed() if p is not None else None
