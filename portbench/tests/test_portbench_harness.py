"""The harness end to end on the CPU at a tiny size (the look for a card
skipped): it finds a cell's files by name, a sound run is correct, and a
run whose timed path is broken underneath is not."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, trace as trace_mod

ROOT = harness.ROOT
CELLS = ["kb100k-hybrid-b512", "kb100k-hybrid-b1"]
# (mode, int8 KB, IVF) of the cells made from the committed files.
VARIANTS = {"int8-hybrid": ("hybrid", True, False),
            "int8-ivf-hybrid_ivf": ("hybrid_ivf", True, True),
            "keyword": ("keyword", False, False),
            "vector": ("vector", False, False)}
SEED = 2**33 + 17
SECONDS = 2.0


def _add_keyword_cell(tmp_path):
    """A copy of the benchmark with a keyword-mode cell added by files
    and a BENCHMARK.json entry alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "kb100k-keyword-b64-tmp",
                               "config": "kb100k-bf16",
                               "traffic": "zipf8-keyword-b64-tmp",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/workloads/zipf8-hybrid-b512.json")
                         .read_text())
    traffic.update(batch=64, mode="keyword")
    (tmp_path / "portbench/workloads/zipf8-keyword-b64-tmp.json").write_text(
        json.dumps(traffic))
    shutil.copy(ROOT / "portbench/limits/kb100k-hybrid-b512.json",
                tmp_path / "portbench/limits/kb100k-keyword-b64-tmp.json")


def test_cell_files_are_found_by_name(tmp_path):
    """A workload added under a new name, with its traffic and limits
    files, loads without an edit to any file the harness has."""
    _add_keyword_cell(tmp_path)
    cell = harness.load_cell("kb100k-keyword-b64-tmp", tmp_path)
    assert cell["traffic"]["batch"] == 64
    assert cell["traffic"]["mode"] == "keyword"
    assert cell["config"]["name"] == "kb100k-bf16"
    assert {m["name"] for m in cell["end_to_end"]} == {
        "qps", "batch_p50_ms", "setup_s"}
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(harness.load_reader(
            m["name"], tmp_path / "portbench").read)


def test_keyword_cell_added_by_files_runs(tmp_path, monkeypatch):
    """That keyword-mode cell runs on the CPU: correct as the program
    stands, not correct with its keyword answers altered."""
    from tpurag_torch.index.inverted import InvertedIndex

    from portbench.tests.conftest import tiny

    _add_keyword_cell(tmp_path)
    cell = tiny("kb100k-keyword-b64-tmp", tmp_path)
    r = harness.run_cell(cell, SEED, SECONDS, False, device="cpu")
    assert r["correct"] and r["sample"] >= 64, r
    monkeypatch.setattr(InvertedIndex, "search", _first_id_moved(
        InvertedIndex.search, 1))
    r = harness.run_cell(cell, SEED, SECONDS, False, device="cpu")
    assert not r["correct"], r["compared"]


def test_every_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read), m["name"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    r = harness.run_cell(tiny_cell(name), SEED, SECONDS, False, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["sample"] >= 64, r
    assert list(r)[-1] == "compared"
    assert set(r["metrics"]) == {"qps", "batch_p50_ms", "setup_s"} | (
        {"batch_p95_ms"} if name == "kb100k-hybrid-b1" else set())


@pytest.mark.parametrize("name", VARIANTS)
def test_sound_run_of_another_path_is_correct(variant_cell, name):
    mode, quant, ivf = VARIANTS[name]
    r = harness.run_cell(variant_cell(mode, quant, ivf), SEED, SECONDS, False,
                         device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["sample"] >= 64, r
    assert r["metrics"]["recall_at_10"]["value"] > 0.9


def _half_left_out(real):
    def f(*a, **kw):
        s, i, b = real(*a, **kw)
        h = s.shape[0] // 2
        s, i, b = s.clone(), i.clone(), b.clone()
        s[h:], i[h:], b[h:] = -3.0e38, -1, 0
        return s, i, b
    return f


def _first_id_moved(real, at):
    def f(*a, **kw):
        out = list(real(*a, **kw))
        ids = out[at].clone()
        ids[:, 0] = torch.where(ids[:, 0] >= 0, (ids[:, 0] + 1) % 1000,
                                ids[:, 0])
        out[at] = ids
        return tuple(out)
    return f


FAULTS = {
    "half of the batch left out": ("tpurag_torch.api.knowledge_base",
                                   "hybrid_search", _half_left_out),
    "a dense answer altered": ("tpurag_torch.index.dense", "dense_topk",
                               lambda r: _first_id_moved(r, 1)),
    "an int8 dense answer altered": ("tpurag_torch.index.dense",
                                     "dense_topk_q8",
                                     lambda r: _first_id_moved(r, 1)),
    "an IVF answer altered": ("tpurag_torch.index.ivf", "ivf_scan",
                              lambda r: _first_id_moved(r, 1)),
}


@pytest.mark.parametrize("name,fault", [
    ("kb100k-hybrid-b512", "half of the batch left out"),
    ("kb100k-hybrid-b512", "a dense answer altered"),
    ("kb100k-hybrid-b512", "a keyword answer altered"),
    ("kb100k-hybrid-b1", "a dense answer altered"),
    ("kb100k-hybrid-b1", "a keyword answer altered"),
    ("int8-ivf-hybrid_ivf", "half of the batch left out"),
    ("int8-ivf-hybrid_ivf", "an IVF answer altered"),
    ("int8-ivf-hybrid_ivf", "a keyword answer altered"),
    ("int8-hybrid", "an int8 dense answer altered"),
    ("vector", "a dense answer altered"),
])
def test_broken_run_is_not_correct(tiny_cell, variant_cell, monkeypatch,
                                   name, fault):
    if fault == "a keyword answer altered":
        from tpurag_torch.index.inverted import InvertedIndex

        monkeypatch.setattr(InvertedIndex, "search", _first_id_moved(
            InvertedIndex.search, 1))
    else:
        module, attr, make = FAULTS[fault]
        mod = sys.modules.get(module) or __import__(module, fromlist=["x"])
        monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    cell = (variant_cell(*VARIANTS[name]) if name in VARIANTS
            else tiny_cell(name))
    r = harness.run_cell(cell, SEED, SECONDS, False, device="cpu")
    assert not r["correct"], r["compared"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kb100k-hybrid-b512", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CPU fallback" in out.stderr
    # Nothing but BENCHMARK.json and the benchmark's folder: no result.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kb100k-hybrid-b512", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def _events():
    """Two calls of a synthetic trace: facade spans with a keyword and a
    dense child, each launching one kernel; a copy launched by the facade
    itself."""
    ev = []
    for c, t in enumerate((0.0, 1000.0)):
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "portbench.search_batch",
             "ts": t, "dur": 900.0, "tid": 1},
            {"ph": "X", "cat": "user_annotation", "name": "portbench.keyword",
             "ts": t + 100, "dur": 200.0, "tid": 1},
            {"ph": "X", "cat": "user_annotation", "name": "portbench.dense",
             "ts": t + 400, "dur": 100.0, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t + 150, "dur": 5.0, "tid": 1, "args": {"correlation": 10 * c + 1}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t + 450, "dur": 5.0, "tid": 1, "args": {"correlation": 10 * c + 2}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
             "ts": t + 700, "dur": 5.0, "tid": 1, "args": {"correlation": 10 * c + 3}},
            {"ph": "X", "cat": "kernel", "name": "void topk_rows_kernel(int*)",
             "ts": t + 200, "dur": 50.0, "args": {"correlation": 10 * c + 1}},
            {"ph": "X", "cat": "kernel", "name": "void dense_scan_sm90_kernel(float*)",
             "ts": t + 460, "dur": 300.0, "args": {"correlation": 10 * c + 2}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
             "ts": t + 760, "dur": 20.0, "args": {"correlation": 10 * c + 3}},
        ]
    return ev


def test_trace_attributes_device_time_to_spans():
    t = trace_mod.Trace(_events())
    assert t.n_calls == 2 and t.window_s == pytest.approx(1900e-6)
    assert t.host_ms("keyword") == pytest.approx(0.2)
    assert t.self_host_ms() == pytest.approx(0.6)
    assert t.device_ms("keyword") == pytest.approx(0.05)
    assert t.device_ms("dense") == pytest.approx(0.3)
    assert t.device_ms("search_batch") == pytest.approx(0.02)
    assert t.busy_s() == pytest.approx(2 * 370e-6)
    assert t.top_ops()[0] == ["dense_scan_sm90_kernel", pytest.approx(600e-6)]
    gaps = t.idle_gaps(20)
    # 780-1200: facade to 900, between calls to 1000, facade to 1100,
    # keyword to 1200; 0-200: facade to 100, keyword; 250-460 keyword to
    # 300, facade to 400, dense.
    assert sum(g[1] for g in gaps if g[0] == "between calls") == \
        pytest.approx(100e-6)
    assert sum(g[1] for g in gaps) == pytest.approx(1900e-6 - 740e-6)
    assert gaps[0] == ["search_batch", pytest.approx(120e-6)]
    run = harness.Run(config={}, traffic={}, trace=t)
    idle = harness.load_reader("device.idle_share").read(run)
    assert idle == pytest.approx(100 * (1 - 740 / 1900))
    assert harness.load_reader("device.ops_per_batch").read(run) == 3
