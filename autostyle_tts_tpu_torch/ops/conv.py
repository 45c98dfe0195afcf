"""1-D conv and layer norm in the channels-last layout [B, T, C].

Counterpart of the JAX ``ops/conv.py`` (``conv1d``, ``layer_norm``).
Weights keep the JAX layout: conv ``w`` [kernel, C_in, C_out], ``b`` [C_out].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, p: dict, dilation: int = 1) -> torch.Tensor:
    """Stride-1 conv with SAME padding (XLA's split: the extra pad goes
    right), channels-last in and out, f32 accumulation, x.dtype out."""
    w = p["w"]
    k = w.shape[0]
    total = (k - 1) * dilation
    left = total // 2
    xt = F.pad(x.float().transpose(1, 2), (left, total - left))
    y = F.conv1d(xt, w.float().permute(2, 1, 0), p["b"].float(), dilation=dilation)
    return y.transpose(1, 2).to(x.dtype)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)
