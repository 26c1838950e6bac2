# Ported from tpurag/kernels/graphops.py (plain torch; no kernel in JAX
# either: the expansion is a padded gather).
"""Graph ops: padded CSR neighbour expansion.

Reference behavior: LightRAG's local/global query modes walk the entity
graph one hop from kNN seed entities (lightrag-hku; surfaced through
lightrag-service/main.py:375-419). The adjacency is flat CSR (neighbour
ids + offsets) and the 1-hop expansion is a padded gather of static
shape (B, K, max_neighbors), -1 beyond each node's degree. The gathers
run on the device of their inputs.
"""

from __future__ import annotations

import torch


def expand_neighbors(seed_ids: torch.Tensor, nbr_offsets: torch.Tensor,
                     nbr_flat: torch.Tensor, max_neighbors: int):
    """Up to max_neighbors 1-hop neighbours of each seed entity.

    seed_ids (B, K) int32, -1 = empty; nbr_offsets (E + 1,) int32 CSR
    offsets; nbr_flat (nnz,) int32 neighbour ids. Returns (B, K,
    max_neighbors) int32, -1-padded."""
    nnz = nbr_flat.shape[0]
    safe = seed_ids.long().clamp(0, nbr_offsets.shape[0] - 2)
    start = nbr_offsets[safe].long()
    deg = nbr_offsets[safe + 1].long() - start
    off = torch.arange(max_neighbors, device=seed_ids.device)
    valid = (off < deg[..., None]) & (seed_ids[..., None] >= 0)
    if nnz == 0:
        return torch.full(valid.shape, -1, dtype=torch.int32,
                          device=seed_ids.device)
    idx = (start[..., None] + off).clamp(0, nnz - 1)
    return torch.where(valid, nbr_flat[idx], -1).to(torch.int32)


def gather_chunks(ent_ids: torch.Tensor, chunk_offsets: torch.Tensor,
                  chunk_flat: torch.Tensor, max_chunks: int):
    """Entity ids (B, M) -> their source chunk ids, (B, M, max_chunks),
    -1-padded."""
    return expand_neighbors(ent_ids, chunk_offsets, chunk_flat, max_chunks)
