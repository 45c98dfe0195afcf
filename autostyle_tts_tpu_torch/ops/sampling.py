"""Token samplers: greedy, temperature, top-k, top-p (nucleus).

Counterpart of the JAX ``ops/sampling.py``. The law is the same
(categorical over the transformed logits); the random stream is torch's,
drawn from an explicit generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0          # 0 = disabled
    greedy: bool = False


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the smallest set whose cumulative probability reaches p (always
    the top-1), over the full vocab."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep, sorted_logits, inf).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def transform_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        logits = _apply_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _apply_top_p(logits, cfg.top_p)
    return logits


def sample(
    logits: torch.Tensor, cfg: SamplerConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """logits [..., V] -> token ids [...] int32."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(transform_logits(logits.float(), cfg), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    picks = torch.multinomial(flat, 1, generator=generator)
    return picks.reshape(probs.shape[:-1]).to(torch.int32)
