"""Seconds in InvertedIndex.compact (the program's `compact_ns` counter):
the keyword index's build onto the device, which the first search runs."""

from portbench import progspans


def read(run):
    return progspans.counter_s("compact_ns", "compactions")
