"""Token samplers: greedy, temperature, top-k, top-p (nucleus).

Counterpart of the JAX ``ops/sampling.py``. The law is the same
(categorical over the transformed logits); the random stream is torch's,
drawn from an explicit generator. The RAG embedder's two samplers are
``SamplerConfig.biography()`` (T=0.7, top-p 0.9) and
``SamplerConfig.label()`` (greedy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0          # 0 = disabled
    greedy: bool = False
    # nucleus fast path: sort only the top ``top_p_cap`` logits (normalized
    # over the full vocabulary); when any row's nucleus is wider the whole
    # call takes the full sort, so the law is always the exact nucleus.
    # 0 = always the full sort
    top_p_cap: int = 256

    @classmethod
    def biography(cls) -> "SamplerConfig":
        return cls(temperature=0.7, top_p=0.9)

    @classmethod
    def label(cls) -> "SamplerConfig":
        return cls(greedy=True)


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def _top_p_full(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the smallest set whose cumulative probability reaches p (always
    the top-1), over the full vocab."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep, sorted_logits, inf).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def _apply_top_p(logits: torch.Tensor, p: float, cap: int = 0) -> torch.Tensor:
    """The exact nucleus. With ``cap`` below the vocabulary only the top
    ``cap`` logits are sorted, their probabilities normalized by a
    logsumexp over the whole vocabulary; if any row's top ``cap`` hold less
    than p, the call takes the full sort (one read of the flag on the host,
    where the reference branches on the device)."""
    if cap and logits.shape[-1] > cap:
        vals = torch.topk(logits, cap, dim=-1).values          # sorted, descending
        probs = torch.exp(vals - torch.logsumexp(logits, dim=-1, keepdim=True))
        cum = torch.cumsum(probs, dim=-1)
        if not bool((cum[..., -1] < p).any()):
            keep = (cum - probs) < p
            inf = torch.full_like(vals, float("inf"))
            thresh = torch.where(keep, vals, inf).min(dim=-1, keepdim=True).values
            return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)
    return _top_p_full(logits, p)


def transform_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        logits = _apply_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _apply_top_p(logits, cfg.top_p, cfg.top_p_cap)
    return logits


def sample(
    logits: torch.Tensor, cfg: SamplerConfig,
    generator: Optional[torch.Generator] = None,
    rows: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """logits [..., V] -> token ids [...] int32. ``rows`` (start, stop,
    total): ``logits`` [stop - start, V] are rows start..stop of a batch of
    ``total`` (a data rank's share): the draw is the whole batch's noise,
    its rows kept, so each row gets the token the whole batch would.
    ``torch.multinomial`` of one sample a row is the argmax of probs /
    Exp(1) noise of the probabilities' shape; that is drawn here."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(transform_logits(logits.float(), cfg), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    if rows is None:
        picks = torch.multinomial(flat, 1, generator=generator)[:, 0]
    else:
        start, stop, total = rows
        noise = torch.empty((total, flat.shape[-1]), dtype=flat.dtype, device=flat.device)
        picks = torch.argmax(flat / noise.exponential_(1, generator=generator)[start:stop], dim=-1)
    return picks.reshape(probs.shape[:-1]).to(torch.int32)
