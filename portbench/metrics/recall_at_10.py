"""Share of the plain reference's exact hybrid top-k ids (fp32 cosine
over the generated vectors, float64 BM25, the same fusion) found in the
program's top-k, over every query the window answered. Meant for cells
whose dense leg is approximate by design and whose traffic asks for 10
results."""

NEEDS = ("ids",)


def read(run):
    if run.traffic["top_k"] != 10:
        raise ValueError("recall_at_10 needs traffic with top_k 10")
    return run.recall()
