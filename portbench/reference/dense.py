"""Exact cosine scores of the generated vectors, in plain PyTorch.

A configuration states the precision its dense scores are taken in:
the corpus rows are L2-normalized and stored in bfloat16, and a query
meets them either as bfloat16 ("bfloat16": bf16 products summed in fp32)
or as float32 ("float32": the exact rescore). The reference takes those
products in float64, so its sums are exact to the configuration's
inputs. "float32_exact" is fp32 cosine over the rows as generated, not
rounded to bf16 (the recall reference); "int8" is the control's lower
precision: rows and queries quantized by max-abs to int8, the integer
dots times both scales.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 1 << 17
QUERY_BLOCK = 4096


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows over their norms as the configuration stores them: the sum of
    squares in fp32, its square root taken in float64 and rounded once."""
    x = x.float()
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.clamp_min(torch.sqrt(ss.double()).float(), 1e-30)


def quantize(x: torch.Tensor):
    """Max-abs int8 codes (as float64) and scales of (N, D) rows."""
    a = x.double()
    m = a.abs().amax(dim=1)
    s = (m / 127.0).clamp_min(1e-300)
    return torch.clamp(torch.round(a / s[:, None]), -127, 127), m / 127.0


class DenseReference:
    """The corpus as the configuration stores it (bf16 rows), and as
    generated (fp32, when `exact_fp32`), on `device`."""

    def __init__(self, blocks, device, exact_fp32: bool = False):
        # fp32 products in full precision: TF32 would round them first.
        torch.backends.cuda.matmul.allow_tf32 = False
        stored, raw = [], []
        for _, _, blk in blocks:
            blk = blk.to(device)
            stored.append(l2_normalize(blk).to(torch.bfloat16))
            if exact_fp32:
                raw.append(blk / torch.linalg.vector_norm(blk, dim=1,
                                                          keepdim=True))
        self.rows = torch.cat(stored)
        self.raw = torch.cat(raw) if exact_fp32 else None
        self.n = self.rows.shape[0]
        self.device = torch.device(device)

    def _query(self, qv, precision: str) -> torch.Tensor:
        q = torch.as_tensor(qv, device=self.device).float()
        if precision == "float32_exact":
            return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        q = l2_normalize(q)
        if precision == "bfloat16":
            q = q.to(torch.bfloat16)
        return q.double()

    def _rows(self, at, precision: str) -> torch.Tensor:
        if precision == "float32_exact":
            return self.raw[at]
        return self.rows[at].double()

    def scores_of(self, qv, ids, precision: str):
        """(B, m) scores of each query against its own ids (-1: NaN)."""
        q = self._query(qv, precision)
        ids = torch.as_tensor(ids, device=self.device, dtype=torch.long)
        rows = self._rows(ids.clamp_min(0), precision)
        if precision == "int8":
            rq, rs = quantize(rows.reshape(-1, rows.shape[-1]))
            qq, qs = quantize(q)
            s = (torch.einsum("bd,bmd->bm", qq, rq.reshape(rows.shape))
                 * qs[:, None] * rs.reshape(ids.shape))
        else:
            s = torch.einsum("bd,bmd->bm", q.to(rows.dtype), rows)
        return torch.where(ids >= 0, s.double(), float("nan")).cpu().numpy()

    def top(self, qv, k: int, precision: str):
        """(scores, ids): each query's k best rows, descending, ties to
        the smaller id, as (B, k) float64 / int64 host arrays."""
        q_all = self._query(qv, precision)
        out_s, out_i = [], []
        for qlo in range(0, q_all.shape[0], QUERY_BLOCK):
            q = q_all[qlo:qlo + QUERY_BLOCK]
            if precision == "int8":
                q, qs = quantize(q)
            best_s = best_i = None
            for lo in range(0, self.n, ROW_BLOCK):
                hi = min(lo + ROW_BLOCK, self.n)
                blk = self._rows(slice(lo, hi), precision)
                if precision == "int8":
                    rq, rs = quantize(blk)
                    s = (q @ rq.T) * qs[:, None] * rs[None, :]
                else:
                    s = q.to(blk.dtype) @ blk.T
                kk = min(k + 8, hi - lo)
                v, i = torch.topk(s, kk, dim=1)
                v, i = v.double(), i + lo
                if best_s is not None:
                    v, i = torch.cat([best_s, v], 1), torch.cat([best_i, i], 1)
                best_s, best_i = _sorted(v, i, k + 8)
            out_s.append(best_s[:, :k].cpu())
            out_i.append(best_i[:, :k].cpu())
        return torch.cat(out_s).numpy(), torch.cat(out_i).numpy()


def _sorted(v: torch.Tensor, i: torch.Tensor, k: int):
    """The k best of (v, i) per row: value descending, ties to the
    smaller id."""
    order = torch.argsort(i, dim=1, stable=True)
    v, i = torch.gather(v, 1, order), torch.gather(i, 1, order)
    order = torch.argsort(-v, dim=1, stable=True)[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)
