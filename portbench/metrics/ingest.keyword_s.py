"""Seconds of set-up in InvertedIndex.add_batch (the program's
`ingest_keyword_ns` counter): tokenizing the chunks and growing the
postings lists, inside add_chunks."""

from portbench import progspans


def read(run):
    return progspans.counter_s("ingest_keyword_ns", "ingest_calls")
