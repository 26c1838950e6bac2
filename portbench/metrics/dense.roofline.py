"""The least time of a batch's exact dense scan, counted from shapes
(2 B N D operations at the bf16 peak, or the corpus and the queries read
once from HBM), as a share of dense.device_ms. For cells whose dense leg
is K1's exact bf16 scan; any other cell is refused."""

from portbench import roofline

SPANS = {"dense": ("dense.search", "_ivf.search")}


def read(run):
    cfg = run.config
    if (cfg["quant"] or cfg["dtype"] != "bfloat16"
            or run.traffic["mode"] not in ("hybrid", "vector")):
        raise ValueError("dense.roofline counts only an exact bf16 scan")
    if run.trace is None:
        return None
    ms = run.trace.device_ms("dense")
    if ms <= 0:
        return None
    least, _ = roofline.dense_exact_ms(run.traffic["batch"],
                                       cfg["corpus"]["n_chunks"], cfg["dim"])
    return 100.0 * least / ms
