"""Exact cosine top-k over an in-memory matrix of L2-normalized rows.

Counterpart of the JAX ``ops/topk.py``: one matmul plus ``torch.topk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def cosine_topk(
    queries: torch.Tensor,              # [Q, D], not necessarily normalized
    db: torch.Tensor,                   # [N, D] normalized rows
    valid: torch.Tensor,                # [N] bool, live rows
    k: int,
    mask: Optional[torch.Tensor] = None,  # [Q, N] or [N], True = keep
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k], indices [Q, k]); invalid rows score -1e30."""
    q = l2_normalize(queries.float())
    sims = q @ db.T
    keep = valid[None, :]
    if mask is not None:
        keep = keep & (mask if mask.ndim == 2 else mask[None, :])
    sims = torch.where(keep, sims, torch.full_like(sims, NEG_INF))
    return torch.topk(sims, k, dim=-1)
