"""dense.roofline's least time, counted from shapes."""

import pytest

from portbench import roofline


def test_dense_exact_counts():
    ms, what = roofline.dense_exact_ms(512, 100_000, 1024)
    assert what == "operations"
    assert ms == pytest.approx(2 * 512 * 100_000 * 1024 / 989e12 * 1e3)
    ms, what = roofline.dense_exact_ms(1, 100_000, 1024)
    assert what == "bytes"
    assert ms == pytest.approx((100_000 * 1024 * 2 + 1024 * 2) / 3.35e12 * 1e3)


def test_dense_roofline_reader():
    from portbench import harness

    reader = harness.load_reader("dense.roofline")

    class T:
        def device_ms(self, name):
            return 0.5 if name == "dense" else 0.0

    run = harness.Run(config={"quant": False, "dtype": "bfloat16", "dim": 1024,
                              "corpus": {"n_chunks": 100_000}},
                      traffic={"mode": "hybrid", "batch": 512}, trace=T())
    assert reader.read(run) == pytest.approx(
        100 * roofline.dense_exact_ms(512, 100_000, 1024)[0] / 0.5)
    run.trace = None
    assert reader.read(run) is None
    run.config["quant"] = True
    with pytest.raises(ValueError):
        reader.read(run)
