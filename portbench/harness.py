"""One run of one cell: the harness behind portbench/run.py.

A cell is a workload of BENCHMARK.json: a configuration
(portbench/configs/<config>.json), a traffic mix
(portbench/workloads/<traffic>.json) and the limits its answers are held
to (portbench/limits/<workload>.json). Each metric is read by
portbench/metrics/<metric>.py. The harness finds all of them by name, so
a cell or a metric is added by adding files and BENCHMARK.json entries.

The window is a closed loop: one caller sends the next batch through the
public ``KnowledgeBase.search_batch(texts, top_k, mode, preset,
vectors)`` as soon as the previous one has returned, each batch drawn
once from the seed's query stream, its vectors host arrays as a remote
embedder would hand them over.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import traceback

import numpy as np

from portbench import check, hostload, trace as trace_mod, \
    traffic as traffic_mod
from portbench.reference.dense import DenseReference

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
SAMPLE_QUERIES = 1024   # answers compared with the reference a run
SLICE_S = 2.0           # the traced run's profiled slice, at least
SLICE_CALLS = 5         # ... and at least this many calls
STREAM_MARGIN = 2.5     # batches drawn: this many windows at warm-up speed


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The workload entry `name` of BENCHMARK.json with its configuration,
    traffic, limits and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    pkg = root / "portbench"
    return {"workload": entry,
            "config": load_json(pkg / "configs" / f"{entry['config']}.json"),
            "traffic": load_json(pkg / "workloads" / f"{entry['traffic']}.json"),
            "limits": load_json(pkg / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_reader(name: str, pkg: pathlib.Path = PKG):
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_kb(config: dict, corpus, device):
    """The configuration's KnowledgeBase, its corpus ingested through
    add_chunks (vectors as generated, on the device) and, where the
    configuration has one, its IVF partition built."""
    from tpurag_torch import Chunk, EngineConfig, KnowledgeBase

    cfg = EngineConfig()
    rows = -(-corpus.n // 2048) * 2048
    cfg = dataclasses.replace(
        cfg, device=dataclasses.replace(cfg.device, min_capacity=rows,
                                        dtype=config["dtype"]))
    if config.get("ivf"):
        cfg = dataclasses.replace(cfg, ivf=dataclasses.replace(
            cfg.ivf, n_lists=config["ivf"]["n_lists"]))
    kb = KnowledgeBase(config["name"], dim=config["dim"], config=cfg,
                       quant=config["quant"], device=device)
    texts, ids, names = corpus.texts, corpus.doc_ids, corpus.doc_names
    for lo, hi, blk in corpus.vector_blocks():
        kb.add_chunks([Chunk(text=texts[i], doc_id=ids[i], doc_name=names[i])
                       for i in range(lo, hi)], vectors=blk)
    if config.get("ivf"):
        kb.build_ivf()
    return kb


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    call_s: list = dataclasses.field(default_factory=list)
    answered: int = 0
    window_s: float = 0.0
    trace: object = None
    recall: object = None


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """One run: set-up, the window, then the comparison and the metrics.
    Returns the result line's object (without `device`'s card fields)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell["config"], cell["traffic"]
    metrics = cell["per_layer"] if traced else cell["end_to_end"]
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    spans: dict = {}
    for r in readers.values():
        for name, paths in getattr(r, "SPANS", {}).items():
            spans.setdefault(name, set()).update(paths)
    keep_ids = any("ids" in getattr(r, "NEEDS", ()) for r in readers.values())

    corpus = traffic_mod.make_corpus(config, seed, device)
    log(f"[setup] corpus: {corpus.n} chunks x {config['dim']} "
        f"({' + '.join(corpus.kind)}; {sum(map(len, corpus.texts)) / corpus.n:.0f}"
        f" characters a chunk), {time.perf_counter() - t_start:.1f}s")
    t0 = time.perf_counter()
    kb = build_kb(config, corpus, device)
    sync(device)
    log(f"[setup] ingest{' + build_ivf' if config.get('ivf') else ''}: "
        f"{time.perf_counter() - t0:.1f}s")
    if traced:
        trace_mod.install_spans(kb, {k: sorted(v) for k, v in spans.items()})

    stream = traffic_mod.QueryStream(corpus, traffic, seed)
    warm = traffic["warmup_batches"]
    stream.draw(warm)
    kw = dict(top_k=traffic["top_k"], mode=traffic["mode"],
              preset=config["preset"]["name"])
    warm_s = []
    for texts, qv, _ in stream.batches[:warm]:
        t0 = time.perf_counter()
        kb.search_batch(texts, vectors=qv, **kw)
        warm_s.append(time.perf_counter() - t0)
    per_call = float(np.median(warm_s[1:] or warm_s))
    expect = max(1.0, seconds / per_call)
    stream.draw(warm + math.ceil(STREAM_MARGIN * expect) + 8)
    keep_p = min(1.0, SAMPLE_QUERIES / (expect * traffic["batch"]))
    corpus.release()
    gc.collect()
    sync(device)
    run = Run(config=config, traffic=traffic)
    run.setup_s = time.perf_counter() - t_start
    log(f"[setup] warm-up {len(warm_s)} calls ({', '.join(f'{s * 1e3:.1f}' for s in warm_s)} ms); "
        f"{len(stream.batches) - warm} batches drawn; setup {run.setup_s:.2f}s")

    # -- the window --------------------------------------------------------
    kept, port_ids = [], []
    state = {"j": warm, "failed": 0, "t1": 0.0}

    def call() -> None:
        """Send batch j, time it, keep what the comparison needs."""
        j = state["j"]
        if j == len(stream.batches):
            stream.draw(j + 64)  # ran past the draw: more, inside the window
        texts, qv, u = stream.batches[j]
        t0 = time.perf_counter()
        try:
            if traced:
                with trace_mod.facade_span():
                    out = kb.search_batch(texts, vectors=qv, **kw)
            else:
                out = kb.search_batch(texts, vectors=qv, **kw)
        except Exception:  # a failed call counts its queries as failed
            if not state["failed"]:
                traceback.print_exc()
            state["failed"] += len(texts)
            out = None
        state["t1"] = t1 = time.perf_counter()
        state["j"] = j + 1
        if out is None:
            return
        run.call_s.append(t1 - t0)
        run.answered += len(texts)
        rows = np.flatnonzero(u < keep_p)
        if len(rows):
            kept.append((j, [(int(r), out[r]) for r in rows]))
        if keep_ids:
            port_ids.append((j, [[x.chunk_id for x in resp.results]
                                 for resp in out]))

    if traced:
        texts, qv, _ = stream.batches[0]
        trace_mod.settle(lambda: kb.search_batch(texts, vectors=qv, **kw))
        run.setup_s = time.perf_counter() - t_start
    trace = None
    host = hostload.Sampler().start()
    t_open = time.perf_counter()
    deadline = t_open + seconds
    while state["t1"] < deadline:
        if traced and trace is None and (time.perf_counter() - t_open
                                         >= seconds / 3):
            # The profiled slice: at least SLICE_S and SLICE_CALLS calls.
            with trace_mod.session() as prof:
                t_slice, j0 = time.perf_counter(), state["j"]
                while state["t1"] < deadline and (
                        state["t1"] - t_slice < SLICE_S
                        or state["j"] - j0 < SLICE_CALLS):
                    call()
            trace = trace_mod.read_profile(prof)
            if trace is None:
                log("[trace] the session recorded no device operation: "
                    "taken again")
            continue
        call()
    failed, t1, j = state["failed"], state["t1"], state["j"]
    run.window_s = t1 - t_open
    log(f"[host] {hostload.describe(host.stop())}")
    n_calls = j - warm
    memory_peak = (torch.cuda.max_memory_allocated()
                   if torch.device(device).type == "cuda" else 0)
    q = np.percentile(run.call_s, [0, 10, 50, 90, 95, 99, 100]) * 1e3 \
        if run.call_s else []
    log(f"[window] {n_calls} calls, {run.answered} queries answered, "
        f"{failed} failed, {run.window_s:.3f}s; call ms min/p10/p50/p90/"
        f"p95/p99/max {' '.join(f'{x:.2f}' for x in q)}")

    # -- after the window: the program's state goes, the reference runs ----
    del kb
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ccell = check.Cell(config, traffic)
    samples = [(j, r, resp) for j, rows in kept for r, resp in rows]
    s_texts = [stream.batches[j][0][r] for j, r, _ in samples]
    s_qv = np.stack([stream.batches[j][1][r] for j, r, _ in samples]) \
        if samples else np.zeros((0, config["dim"]), np.float32)
    answers = [_answer(resp, corpus) for _, _, resp in samples]
    answered = [stream.batches[j] for j, _ in port_ids]
    all_texts = [t for b in answered for t in b[0]] + s_texts
    bm = corpus.bm25(config["bm25"]["k1"], config["bm25"]["b"], all_texts)
    dense = DenseReference(corpus.vector_blocks(), device,
                           exact_fp32=keep_ids)
    corpus.release()
    compared = check.compare(ccell, answers, s_qv, s_texts, dense, bm,
                             corpus.n)
    log(f"[check] {len(answers)} answers compared in "
        f"{time.perf_counter() - t0:.1f}s")
    if keep_ids:
        def recall():
            qv_all = np.concatenate([b[1] for b in answered])
            texts_all = [t for b in answered for t in b[0]]
            flat = [ids for _, call in port_ids for ids in call]
            return check.recall(ccell, flat, qv_all, texts_all, dense, bm)
        run.recall = recall
    run.trace = trace

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cell["limits"]
    result = {"correct": failed == 0 and all(
                  compared[k] <= lim for k, lim in limits.items()),
              "attempted": run.answered + failed, "failed": failed,
              "metrics": values,
              "device": {"memory_peak_bytes": int(memory_peak)}}
    if traced and trace is not None:
        result["device"].update(busy_s=trace.busy_s(),
                                window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["sample"] = len(answers)
    result["compared"] = {k: {"value": compared[k], "limit": lim}
                          for k, lim in limits.items()}
    return result


def _answer(resp, corpus):
    """One SearchResponse as compare()'s answer list."""
    out = []
    for r in resp.results:
        bits = (("vector" in r.found_in) + 2 * ("keyword" in r.found_in)
                if set(r.found_in) <= {"vector", "keyword"} else 0)
        ok = (0 <= r.chunk_id < corpus.n
              and r.text == corpus.texts[r.chunk_id]
              and r.doc_name == corpus.doc_names[r.chunk_id])
        out.append((int(r.chunk_id), float(r.score), int(bits), bool(ok)))
    return out
