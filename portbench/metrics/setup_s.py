"""Seconds from the start of the process to the window: loading,
building the kernel library where it is not built yet, making the corpus,
ingest through add_chunks, build_ivf, warm-up and the query draws."""


def read(run):
    return run.setup_s
