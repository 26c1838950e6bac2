"""Tiny cells for the benchmark's CPU tests: each workload of
BENCHMARK.json with its corpus cut to a few thousand chunks of width 64
and batches of at most 32, run on the CPU through the port's plain
versions; and, for the paths no committed cell takes yet (an int8 KB,
the IVF, a leg alone), cells made from the same files with a few keys
changed."""

import copy
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

torch.set_num_threads(1)  # several test processes share the CPU

LIMITS = {"dense_gap": 1e-05, "keyword_gap": 0.001, "bad_answers": 0}


def shrink(cell: dict) -> dict:
    c = cell["config"]
    c["corpus"]["n_chunks"] = 1200
    c["corpus"]["texts"].update(vocab=4000, doc_chunks=8)
    if c["corpus"]["vectors"]["kind"] == "mixture":
        c["corpus"]["vectors"].update(n_centers=32, block_rows=512)
    if c.get("ivf"):
        c["ivf"]["n_lists"] = 32
    c["dim"] = 64
    cell["traffic"]["batch"] = min(cell["traffic"]["batch"], 32)
    cell["traffic"]["warmup_batches"] = 2
    return cell


def tiny(name: str, root=ROOT) -> dict:
    return shrink(harness.load_cell(name, root))


def variant(mode: str, quant: bool = False, ivf: bool = False,
            top_k: int = 10) -> dict:
    """The b512 cell's files with the KB made int8 and / or given an
    IVF partition over mixture vectors, and the search mode changed."""
    cell = copy.deepcopy(harness.load_cell("kb100k-hybrid-b512", ROOT))
    c, t = cell["config"], cell["traffic"]
    c["quant"] = quant
    if ivf:
        c["ivf"] = {"n_lists": 32}
        c["corpus"]["vectors"] = {"kind": "mixture", "n_centers": 32,
                                  "noise": 0.3, "block_rows": 512}
        t["queries"]["vectors"] = {"kind": "mixture"}
    t.update(mode=mode, top_k=top_k)
    cell["limits"] = dict(LIMITS)
    cell["end_to_end"] = [m for m in cell["end_to_end"]
                          if m["name"] != "batch_p95_ms"]
    cell["end_to_end"].append({"name": "recall_at_10", "unit": "ratio"})
    return shrink(cell)


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture
def variant_cell():
    return variant
