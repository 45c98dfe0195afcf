"""1-D conv and layer norm in the channels-last layout [B, T, C].

Counterpart of the JAX ``ops/conv.py`` (``conv1d``, ``conv1d_init``,
``conv_transpose1d``, ``conv_transpose1d_init``, ``layer_norm``,
``layer_norm_init``). Weights keep the JAX layout: conv and transposed conv
``w`` [kernel, C_in, C_out], ``b`` [C_out].
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from ..weights import uniform


def conv1d_init(generator: torch.Generator, in_ch: int, out_ch: int, kernel: int) -> dict:
    std = 1.0 / math.sqrt(in_ch * kernel)
    return {"w": uniform((kernel, in_ch, out_ch), generator, -std, std),
            "b": uniform((out_ch,), generator, -std, std)}


def conv1d(x: torch.Tensor, p: dict, stride: int = 1, dilation: int = 1,
           padding: Union[str, Tuple[int, int]] = "SAME") -> torch.Tensor:
    """Conv with XLA's SAME padding (the default): ceil(T / stride)
    outputs, the total pad max((out - 1) * stride + (k - 1) * dilation + 1
    - T, 0) split with the extra sample on the right; or with an explicit
    ``(left, right)`` zero padding, as torch's ``Conv1d(padding=p)`` is
    ``(p, p)``. Channels-last in and out, f32 accumulation, x.dtype out."""
    w = p["w"]
    if isinstance(padding, str):
        if padding != "SAME":
            raise ValueError(f"conv1d: padding must be 'SAME' or (left, right), got {padding!r}")
        k, T = w.shape[0], x.shape[1]
        n_out = -(-T // stride)
        total = max((n_out - 1) * stride + (k - 1) * dilation + 1 - T, 0)
        left, right = total // 2, total - total // 2
    else:
        left, right = padding
    xt = F.pad(x.float().transpose(1, 2), (left, right))
    y = F.conv1d(xt, w.float().permute(2, 1, 0), p["b"].float(), stride=stride, dilation=dilation)
    return y.transpose(1, 2).to(x.dtype)


def conv_transpose1d_init(generator: torch.Generator, in_ch: int, out_ch: int, kernel: int) -> dict:
    return conv1d_init(generator, in_ch, out_ch, kernel)


def conv_transpose1d(x: torch.Tensor, p: dict, stride: int, kernel: int) -> torch.Tensor:
    """Fractionally strided conv with T * stride outputs, as the reference
    defines it: flipped taps over the input dilated by ``stride``, padded
    (k-1-pad_l, k-1-pad_r) with pad_l = (k-s) - (k-s)//2. That is the full
    transposed conv cropped to [pad_l, pad_l + T*stride): torch's symmetric
    ``padding=`` cannot express an odd k - s."""
    w = p["w"]
    T = x.shape[1]
    pad_l = (kernel - stride) - (kernel - stride) // 2
    y = F.conv_transpose1d(x.float().transpose(1, 2), w.float().permute(1, 2, 0), p["b"].float(),
                           stride=stride)
    return y[:, :, pad_l : pad_l + T * stride].transpose(1, 2).to(x.dtype)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def layer_norm_init(dim: int, device=None) -> dict:
    return {"scale": torch.ones((dim,), device=device), "bias": torch.zeros((dim,), device=device)}
