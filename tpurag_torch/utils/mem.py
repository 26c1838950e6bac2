# Ported from tpurag/utils/mem.py.
"""Host-memory hygiene helpers for multi-GB memmap passes."""

from __future__ import annotations

import numpy as np


def drop_memmap_pages(arr) -> None:
    """Flush a memmap's dirty pages and advise the kernel to release
    its resident ones. Streaming builds and bulk ingest walk multi-GB
    staging/corpus memmaps end to end; without this every touched page
    stays charged to the process. No-op for plain (non-memmap) arrays."""
    import mmap as _mmap

    base = getattr(arr, "_mmap", None)
    if base is None:
        return
    if isinstance(arr, np.memmap):
        arr.flush()
    if hasattr(base, "madvise"):
        base.madvise(_mmap.MADV_DONTNEED)
