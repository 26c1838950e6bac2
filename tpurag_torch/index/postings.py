"""Batched keyword postings: the documents of an ``InvertedIndex.add_batch``
tokenized, counted and grouped by term in native calls.

:func:`batch_postings` runs the host library's ``tr_batch_postings``
(``csrc/host/tokenizer.cc``, the JAX package's native tokenizer) over
calls of at most ``MAX_CALL_BYTES`` of UTF-8 text, the GIL released for
each, and yields each call's postings as numpy arrays, grouped by term in
first-occurrence order and by document arrival within a term: the order
``InvertedIndex.add`` appends them in, one document after another. A
call tokenizes ranges of its documents on up to one thread a CPU this
process may run on, at least ``MIN_THREAD_BYTES`` of text each; the
output does not depend on the number of threads.

Its tokens equal :func:`tpurag_torch.ingest.tokenizer.tokenize`'s, the
spec, on every code point (lone surrogates included: they are encoded
with ``surrogatepass`` and separate tokens on both sides).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, NamedTuple

import numpy as np

from tpurag_torch.kernels.runtime import load_host_library

# A call's counts are 32-bit: its output (8 bytes a posting, at most one
# posting per two bytes of text, and the terms) stays under 4 GiB.
MAX_CALL_BYTES = 1 << 28
MIN_THREAD_BYTES = 1 << 20  # a thread's start costs ~tens of us
_U64P = ctypes.POINTER(ctypes.c_uint64)


class Postings(NamedTuple):
    """One native call's documents, ``texts[lo:hi]`` of the batch."""

    lo: int
    hi: int
    terms: list[str]        # the call's distinct terms, first occurrence first
    doc_total: np.ndarray   # (hi - lo,) tokens a document
    term_docs: np.ndarray   # (len(terms),) postings a term
    doc: np.ndarray         # int32 index in texts[lo:hi] a posting
    tf: np.ndarray          # int32 term frequency a posting


def library():
    """The host library with tr_batch_postings bound, or None where it
    cannot be built or loaded."""
    lib = load_host_library()
    if (lib is not None
            and lib.tr_batch_postings.restype is not ctypes.c_void_p):
        lib.tr_batch_postings.argtypes = (ctypes.c_char_p, _U64P,
                                          ctypes.c_uint64, ctypes.c_uint32)
        lib.tr_free.argtypes = (ctypes.c_void_p,)
        lib.tr_free.restype = None
        lib.tr_batch_postings.restype = ctypes.c_void_p
    return lib


def fits(texts: list[str]) -> bool:
    """True when each text fits one native call: at most MAX_CALL_BYTES
    of UTF-8 at four bytes a character."""
    return 4 * max(map(len, texts), default=0) <= MAX_CALL_BYTES


def batch_postings(lib, texts: list[str]) -> Iterator[Postings]:
    """Every text's postings, one :class:`Postings` a native call, in
    order. A text longer than MAX_CALL_BYTES raises ValueError."""
    blobs = [t.encode("utf-8", "surrogatepass") for t in texts]
    sizes = np.fromiter(map(len, blobs), np.int64, len(blobs))
    if len(sizes) and sizes.max() > MAX_CALL_BYTES:
        raise ValueError("batch_postings: a text is longer than "
                         f"{MAX_CALL_BYTES} bytes")
    lo = 0
    while lo < len(blobs):
        ends = np.cumsum(sizes[lo:])
        hi = lo + int(np.searchsorted(ends, MAX_CALL_BYTES, side="right"))
        yield _call(lib, blobs, lo, hi)
        lo = hi


def _cpus() -> int:
    return len(os.sched_getaffinity(0))


def _call(lib, blobs: list[bytes], lo: int, hi: int) -> Postings:
    offs = np.zeros(hi - lo + 1, np.uint64)
    np.cumsum([len(b) for b in blobs[lo:hi]], out=offs[1:])
    threads = max(1, min(_cpus(), int(offs[-1]) // MIN_THREAD_BYTES))
    ptr = lib.tr_batch_postings(b"".join(blobs[lo:hi]),
                                offs.ctypes.data_as(_U64P), hi - lo, threads)
    if not ptr:
        raise MemoryError("tr_batch_postings: out of memory")
    try:
        size = int.from_bytes(ctypes.string_at(ptr, 4), "little")
        raw = (ctypes.c_char * size).from_address(ptr)
        n_unique, arena, n_docs, pairs = (
            int(x) for x in np.frombuffer(raw, np.uint32, 4, offset=4))
        words = bytes(memoryview(raw)[20:20 + arena])
        terms = []
        pos = 0
        for _ in range(n_unique):
            n = int.from_bytes(words[pos:pos + 4], "little")
            terms.append(words[pos + 4:pos + 4 + n].decode("utf-8"))
            pos += 4 + n
        ints = np.frombuffer(raw, np.uint32, offset=20 + arena)
        doc_total = ints[:n_docs].astype(np.int64)
        term_docs = ints[n_docs:n_docs + n_unique].astype(np.int64)
        flat = ints[n_docs + n_unique:].view(np.int32)
        doc, tf = flat[:pairs].copy(), flat[pairs:2 * pairs].copy()
    finally:
        lib.tr_free(ptr)
    return Postings(lo, hi, terms, doc_total, term_docs, doc, tf)
