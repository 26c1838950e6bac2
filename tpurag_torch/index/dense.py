# Ported from tpurag/index/dense.py (device store, single device).
"""Device-resident dense vector index.

A growable, padded (capacity, D) matrix on an explicit device:

- rows are L2-normalized at insert, so dot == cosine;
- capacity grows by doubling;
- deletes tombstone the row (zeroed in place + filtered after the
  search with an overfetch of one slot per tombstone);
- quant=True keeps an int8 max-abs sidecar of the rows (codes + one scale
  per row, derived data, never saved) and searches it with K5, then
  rescores 2k candidates against the storage rows with K8
  (kernels/quant.py), so final scores stay exact cosines;
- save/load use the JAX package's on-disk format (``<path>.meta.json`` +
  ``<path>.emb.npy`` in the storage dtype; bf16 rows as a uint16 view),
  so an index saved by either package loads in the other; load also
  reads the round-1 ``<path>.npz`` (fp32 rows and a JSON meta entry).

The port updates the matrix in place (adds and deletes write rows of the
existing tensor) where the JAX package rebuilt immutable arrays.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from tpurag_torch.kernels.dense import dense_topk
from tpurag_torch.kernels.quant import dense_topk_q8, quantize_rows
from tpurag_torch.kernels.runtime import NEG_INF, round_up
from tpurag_torch.utils import tracing

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise TypeError(f"unsupported storage dtype {dtype}")
        return dtype
    if str(dtype) not in _DTYPES:
        raise TypeError(f"unsupported storage dtype {dtype!r}")
    return _DTYPES[str(dtype)]


def l2_normalize(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Rows over their fp32 norms. The square root is taken in float64
    and rounded once to fp32, which is correctly rounded, as the JAX
    package's is (torch's vectorized fp32 sqrt on the CPU can be one ulp
    off)."""
    x = x.float()
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    norm = torch.sqrt(ss.double()).float()
    return x / torch.clamp_min(norm, eps)


def to_storage(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array in the on-disk storage form (uint16 bf16 payloads or
    float32) -> a CPU tensor of the storage dtype."""
    arr = np.array(arr)  # a writable copy (load() passes a read-only mmap)
    if dtype == torch.bfloat16:
        if arr.dtype == np.uint16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).to(dtype)
    return torch.from_numpy(np.asarray(arr, np.float32))


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")


class DenseIndex:
    def __init__(self, dim: int, dtype=torch.bfloat16, capacity: int = 4096,
                 device="cuda", mesh=None, quant: bool = False,
                 store: str = "device", backing=None):
        if mesh is not None:
            raise not_ported("DenseIndex(mesh=...) (Queue 1, 'Sharding')")
        if store != "device" or backing is not None:
            raise not_ported("DenseIndex(store='host') (Queue 1, "
                             "'host store')")
        self.dim = dim
        self.dtype = as_dtype(dtype)
        self.device = torch.device(device)
        self.capacity = round_up(max(capacity, 128), 128)
        self._emb = torch.zeros((self.capacity, dim), dtype=self.dtype,
                                device=self.device)
        self.quant = bool(quant)
        self._q8 = self._qscale = None
        if self.quant:
            self._q8 = torch.zeros((self.capacity, dim), dtype=torch.int8,
                                   device=self.device)
            self._qscale = torch.zeros((self.capacity,), dtype=torch.float32,
                                       device=self.device)
        self.n_active = 0
        self._deleted: set[int] = set()

    # -- mutation ----------------------------------------------------------

    def _grow_to(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        if new_cap != self.capacity:
            grown = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                                device=self.device)
            grown[: self.capacity] = self._emb
            self._emb = grown
            if self.quant:
                q8 = torch.zeros((new_cap, self.dim), dtype=torch.int8,
                                 device=self.device)
                q8[: self.capacity] = self._q8
                qs = torch.zeros((new_cap,), dtype=torch.float32,
                                 device=self.device)
                qs[: self.capacity] = self._qscale
                self._q8, self._qscale = q8, qs
            self.capacity = new_cap

    def add(self, vectors) -> np.ndarray:
        """Insert (M, D) raw vectors; returns their int32 row ids."""
        vecs = l2_normalize(torch.as_tensor(vectors).to(self.device))
        if vecs.dim() == 1:
            vecs = vecs[None]
        m = vecs.shape[0]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vecs.shape[1]} != {self.dim}")
        self._grow_to(self.n_active + m)
        rows = vecs.to(self.dtype)
        self._emb[self.n_active:self.n_active + m] = rows
        if self.quant:
            # Quantize the STORAGE-dtype rows (not the fp32 input): load()
            # rebuilds the sidecar from them, so the int8 codes, and with
            # them the candidate set near the recall boundary, survive a
            # save/load round-trip bit for bit.
            r8, rs = quantize_rows(rows)
            self._q8[self.n_active:self.n_active + m] = r8
            self._qscale[self.n_active:self.n_active + m] = rs
        ids = np.arange(self.n_active, self.n_active + m, dtype=np.int32)
        self.n_active += m
        return ids

    def delete(self, ids) -> None:
        ids = [int(i) for i in np.atleast_1d(ids)]
        live = [i for i in ids
                if 0 <= i < self.n_active and i not in self._deleted]
        if not live:
            return
        self._deleted.update(live)
        rows = torch.as_tensor(sorted(live), dtype=torch.long,
                               device=self.device)
        self._emb[rows] = 0
        if self.quant:
            self._q8[rows] = 0
            self._qscale[rows] = 0.0

    # -- query -------------------------------------------------------------

    @tracing.spanned("dense")
    def search(self, queries, k: int):
        """Top-k cosine. queries: (B, D) raw (normalized here).

        Returns (scores, ids) as (B, min(k, n_active)) float32 / int32
        tensors on the index's device; tombstoned slots are (NEG_INF, -1)."""
        q = torch.as_tensor(queries).to(self.device)
        if q.dim() == 1:
            q = q[None, :]
        b = q.shape[0]
        if self.n_active == 0:
            return (torch.full((b, k), NEG_INF, device=self.device),
                    torch.full((b, k), -1, dtype=torch.int32,
                               device=self.device))
        q = l2_normalize(q)
        # Overfetch to absorb tombstones, then filter.
        extra = min(len(self._deleted), max(self.n_active - k, 0))
        kk = min(k + extra, self.n_active)
        if self.quant:
            scores, ids = dense_topk_q8(q, self._q8, self._qscale,
                                        self.n_active, kk,
                                        rescore_emb=self._emb)
        else:
            scores, ids = dense_topk(q, self._emb, self.n_active, kk)
        if self._deleted:
            dead = torch.isin(ids, torch.as_tensor(
                sorted(self._deleted), dtype=torch.int32, device=self.device))
            s = torch.where(dead, NEG_INF, scores)
            order = torch.argsort(-s, dim=1, stable=True)[:, :k]
            s = torch.gather(s, 1, order)
            i = torch.where(s <= NEG_INF / 2, -1, torch.gather(ids, 1, order))
            scores, ids = s, i
        return scores[:, :k], ids[:, :k]

    def get_rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) in the storage dtype, on the index's device (a
        view): the bounded block accessor streaming IVF builds read from."""
        return self._emb[lo:hi]

    def get_vectors(self, ids) -> np.ndarray:
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return self._emb[rows].float().cpu().numpy()

    @property
    def embeddings(self) -> torch.Tensor:
        """The padded device matrix (capacity, D)."""
        return self._emb

    def __len__(self) -> int:
        return self.n_active - len(self._deleted)

    # -- persistence -------------------------------------------------------

    def storage_array(self) -> np.ndarray:
        """Rows [0, n_active) in the on-disk storage form."""
        rows = self._emb[: self.n_active].cpu()
        if self.dtype == torch.bfloat16:
            return rows.view(torch.int16).numpy().view(np.uint16)
        return rows.numpy()

    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {
            "dim": self.dim,
            "dtype": _NAMES[self.dtype],
            "n_active": self.n_active,
            "deleted": sorted(self._deleted),
            "n_shards": 1,
            "capacity": self.capacity,
        }
        (path.parent / (path.name + ".meta.json")).write_text(json.dumps(meta))
        np.save(path.parent / (path.name + ".emb.npy"), self.storage_array())

    def _rebuild_quant(self) -> None:
        """(Re)quantize the whole matrix into the int8 sidecar: one pass
        at load time; zero rows (padding, tombstones) get scale 0, so they
        can never outrank a live row."""
        self._q8, self._qscale = quantize_rows(self._emb)

    @classmethod
    def from_numpy(cls, emb: np.ndarray, dtype="bfloat16", deleted=(),
                   device="cuda", quant: bool = False) -> "DenseIndex":
        """An index over rows already normalized and in storage form
        (uint16 bf16 payloads or float32), as save() writes them."""
        n, dim = emb.shape
        idx = cls(dim, dtype=dtype, capacity=max(n, 128), device=device)
        idx._grow_to(n)
        if n:
            idx._emb[:n] = to_storage(emb, idx.dtype).to(idx.device)
        idx.n_active = n
        idx._deleted = {int(i) for i in deleted}
        if quant:
            idx.quant = True
            idx._rebuild_quant()
        return idx

    @classmethod
    def load(cls, path, device="cuda", quant: bool = False) -> "DenseIndex":
        """quant: rebuild the int8 sidecar after the rows load (it is
        derived data, never saved). Without a .meta.json, the round-1
        format: one .npz of fp32 rows (`emb`) and a JSON `meta` entry."""
        path = pathlib.Path(path)
        meta_file = path.parent / (path.name + ".meta.json")
        if not meta_file.exists():  # legacy round-1 .npz (fp32)
            data = np.load(path.with_suffix(".npz"), allow_pickle=False)
            meta = json.loads(str(data["meta"]))
            emb = np.asarray(data["emb"], np.float32).reshape(-1, meta["dim"])
            return cls.from_numpy(emb[:meta["n_active"]], dtype=meta["dtype"],
                                  deleted=meta["deleted"], device=device,
                                  quant=quant)
        meta = json.loads(meta_file.read_text())
        if meta["n_shards"] != 1:
            raise not_ported("loading a sharded dense index (Queue 1, "
                             "'Sharding')")
        emb = np.load(path.parent / (path.name + ".emb.npy"), mmap_mode="r")
        return cls.from_numpy(emb, dtype=meta["dtype"],
                              deleted=meta["deleted"], device=device,
                              quant=quant)
