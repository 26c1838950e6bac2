"""Seconds of set-up in KnowledgeBase.add_chunks (the program's
`ingest_ns` counter): tokenizing, postings, the vectors' upload."""

from portbench import progspans


def read(run):
    return progspans.counter_s("ingest_ns", "ingest_calls")
