"""Batched highlighting: every keyword-found result of a search in one
native call.

:func:`highlight_batch` marks each text with its query's tokens through
the host library's ``tr_highlight_batch`` (``csrc/host/highlight.cc``):
one shift-and pass over each text's ASCII-folded UTF-8 finds the longest
token at every start, then a walk keeps the leftmost ones; the GIL is
released for the call.
Its output equals :func:`tpurag_torch.index.inverted.highlight`, the
spec, string for string. The native path takes a text only where that
holds by construction:

- every character of its query's tokens is ASCII or uncased
  (``c.lower() == c == c.upper()``: CJK, kana, Hangul, all that
  ``tokenize_query`` emits besides ASCII);
- the text holds none of the four non-ASCII characters that
  ``re.IGNORECASE`` matches to ASCII letters: U+0130, U+0131, U+017F,
  U+212A, and no token of its query is longer than 64 bytes (the
  library flags both).

Every other text, and every text when the library cannot be built or
loaded, goes through ``highlight``; the count comes back as fallbacks.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpurag_torch.index.inverted import highlight
from tpurag_torch.kernels.runtime import load_host_library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = (ctypes.c_char_p, _I64, _P, _I64, ctypes.c_int, _P,
             ctypes.c_char_p, _P, _P, ctypes.c_char_p, _I64, _I64, _P, _P,
             ctypes.POINTER(_P), ctypes.POINTER(_I64))


def _library():
    lib = load_host_library()
    if lib is not None and lib.tr_highlight_batch.restype is not _P:
        lib.tr_highlight_batch.argtypes = _ARGTYPES
        lib.tr_highlight_free.argtypes = (_P,)
        lib.tr_highlight_free.restype = None
        lib.tr_highlight_batch.restype = _P
    return lib


def native_tokens(tokens: list[str]) -> bool:
    """True when re.IGNORECASE matches each token character only to
    itself or, for an ASCII letter, to its other case (and the gated
    four): the characters the native path compares byte for byte."""
    return all(t.isascii() or all(c.lower() == c == c.upper() for c in t)
               for t in tokens)


def _utf8(s: str) -> bytes:
    return s.encode("utf-8", "surrogatepass")


def highlight_batch(texts: list[str], tokens: list[list[str]],
                    which: list[int], mark: str = "**"
                    ) -> tuple[list[str], int]:
    """``[highlight(t, tokens[q], mark) for t, q in zip(texts, which)]``
    in one native call; returns it with the number of texts that took the
    Python version."""
    n = len(texts)
    lib = _library() if n else None
    if lib is None:
        return [highlight(t, tokens[q], mark)
                for t, q in zip(texts, which)], n
    which_a = np.asarray(which, np.int64)
    if which_a.min() < 0 or which_a.max() >= len(tokens):
        raise IndexError("highlight_batch: a query index is out of range")
    which_a = which_a.astype(np.int32)
    ok = [native_tokens(toks) for toks in tokens]
    flat: list[str] = []
    query_tok = np.zeros(len(tokens) + 1, np.int64)
    for q, toks in enumerate(tokens):
        if ok[q]:
            flat.extend(toks)
        query_tok[q + 1] = len(flat)
    tok_off = np.zeros(len(flat) + 1, np.int64)
    np.cumsum([len(t) if t.isascii() else len(_utf8(t)) for t in flat],
              out=tok_off[1:])
    fallback = (~np.asarray(ok, bool)[which_a]).astype(np.uint8)
    joined = "".join(texts)
    text = _utf8(joined)
    chars = np.fromiter(map(len, texts), np.int64, n)
    out_chars = np.empty(n + 1, np.int64)
    mark_b = _utf8(mark)
    out, out_len = _P(), _I64()
    handle = lib.tr_highlight_batch(
        text, len(text), chars.ctypes.data, n, int(joined.isascii()),
        which_a.ctypes.data, _utf8("".join(flat)), tok_off.ctypes.data,
        query_tok.ctypes.data, mark_b, len(mark_b), len(mark),
        fallback.ctypes.data, out_chars.ctypes.data, ctypes.byref(out),
        ctypes.byref(out_len))
    if not handle:
        raise MemoryError("tr_highlight_batch: out of memory")
    try:
        marked = str((ctypes.c_char * out_len.value).from_address(out.value),
                     "utf-8", "surrogatepass") if out_len.value else ""
    finally:
        lib.tr_highlight_free(handle)
    offs = out_chars.tolist()
    res = [highlight(t, tokens[q], mark) if f else marked[a:b]
           for t, q, f, a, b in zip(texts, which, fallback.tolist(), offs,
                                    offs[1:])]
    return res, int(fallback.sum())
