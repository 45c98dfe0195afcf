"""HiFT/NSF vocoder compat: converted hift.pt -> 22.05 kHz waveform.

Counterpart of the JAX ``models/compat/hift.py``. The CosyVoice-300M
``hift.pt`` holds an NSF-HiFiGAN ("HiFT") generator: an f0 predictor over
mel, a harmonic-plus-noise source module whose sine excitation is
STFT-analyzed and fused into every upsampling stage, ConvTranspose
upsampling with multi-receptive-field resblocks, and an iSTFT head
(``conv_post`` emits n_fft/2+1 log-magnitudes and as many phase channels;
n_fft=16, hop=4 by default) on ``ops/stft.istft_overlap_add``. Weight-normed
torch convs arrive materialized (``fuse_op="weight_norm"`` in the rule
tables). The f0 predictor uses SAME padding, as the JAX module does.

``harmonic_source`` and ``apply`` take the source's random initial phases
and its noise as arguments when given (the tests inject the JAX draws),
else draw them from a ``torch.Generator``. The phase is an f32 cumulative
sum over every sample, which XLA and PyTorch add in different orders: the
two agree to f32 rounding on short outputs, and ``sin`` amplifies the
drift over long ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.conv import conv1d, conv_transpose1d
from ...ops.stft import _dft_basis_on, _reflect_pad, frame_signal, istft_overlap_add

Params = Dict


@dataclass(frozen=True)
class HiFTConfig:
    n_mels: int = 80
    sampling_rate: int = 22050
    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernels: Tuple[int, ...] = (16, 16)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernels: Tuple[int, ...] = (7, 11)
    source_resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5))
    istft_n_fft: int = 16
    istft_hop: int = 4
    nb_harmonics: int = 8
    sine_amp: float = 0.1
    noise_std: float = 0.003
    voiced_threshold: float = 10.0

    @property
    def samples_per_frame(self) -> int:
        out = self.istft_hop
        for r in self.upsample_rates:
            out *= r
        return out


def infer_config(tree: Params, n_mels: int = 80) -> HiFTConfig:
    """Read kernel geometry off a converted tree (rates/kernels from the
    ConvTranspose weights; resblock kernels/dilations keep defaults — the
    dilation schedule is not recoverable from shapes)."""
    ups = [tree["ups"][k] for k in sorted(tree["ups"], key=int)]
    kernels = tuple(int(u["w"].shape[0]) for u in ups)
    # upstream convention k = 2*rate
    rates = tuple(k // 2 for k in kernels)
    n_bins = int(tree["conv_post"]["w"].shape[2]) // 2
    n_fft = 2 * (n_bins - 1)
    rk = []
    rd = []
    for k in sorted(tree["resblocks"], key=int):
        c1 = tree["resblocks"][k]["convs1"]
        rk.append(int(c1["0"]["w"].shape[0]))
        rd.append(tuple((1, 3, 5)[: len(c1)]))
    n_up = len(rates)
    n_res = len(rk) // n_up if n_up else len(rk)
    srk = []
    srd = []
    for k in sorted(tree.get("source_resblocks", {}), key=int):
        c1 = tree["source_resblocks"][k]["convs1"]
        srk.append(int(c1["0"]["w"].shape[0]))
        srd.append((1, 3, 5)[: len(c1)])
    return HiFTConfig(
        n_mels=n_mels,
        nb_harmonics=int(tree["m_source"]["l_linear"]["w"].shape[0]) - 1,
        upsample_rates=rates,
        upsample_kernels=kernels,
        resblock_kernels=tuple(rk[:n_res]),
        resblock_dilations=tuple(rd[:n_res]),
        source_resblock_kernels=tuple(srk),
        source_resblock_dilations=tuple(srd),
        istft_n_fft=n_fft,
        istft_hop=n_fft // 4,
    )


# ------------------------------------------------------------------ source module


def f0_predict(tree: Params, mel: torch.Tensor) -> torch.Tensor:
    """ConvRNNF0Predictor: weight-normed conv+ELU stack + linear classifier
    -> |f0| per mel frame [B, F]."""
    h = mel
    for p in [tree["condnet"][k] for k in sorted(tree["condnet"], key=int)]:
        h = F.elu(conv1d(h, p))
    f0 = h @ tree["classifier"]["w"] + tree["classifier"]["b"]
    return torch.abs(f0[..., 0])


def harmonic_source(
    tree: Params,
    cfg: HiFTConfig,
    f0_up: torch.Tensor,                 # [B, T_samples] f0 upsampled to sample rate
    init_phase: torch.Tensor,            # [B, 1, H] radians (the fundamental's is set to 0)
    noise: torch.Tensor,                 # [B, T_samples, H] standard normal
) -> torch.Tensor:
    """SourceModuleHnNSF: per-harmonic sines (phase = cumsum of inst. freq,
    random initial phase for overtones), voiced/unvoiced gating + noise,
    merged by l_linear + tanh -> [B, T_samples] excitation."""
    H = cfg.nb_harmonics + 1
    mult = torch.arange(1, H + 1, dtype=torch.float32, device=f0_up.device)[None, None, :]
    rad = (f0_up[..., None] * mult) / cfg.sampling_rate      # [B, T, H]
    init = init_phase.float().clone()
    init[:, :, 0] = 0.0                                      # the fundamental starts at 0
    phase = 2 * math.pi * torch.cumsum(rad, dim=1) + init
    sines = cfg.sine_amp * torch.sin(phase)
    uv = (f0_up > cfg.voiced_threshold).float()[..., None]
    noise_amp = uv * cfg.noise_std + (1 - uv) * cfg.sine_amp / 3.0
    waves = uv * sines + noise_amp * noise                   # [B, T, H]
    merged = waves @ tree["l_linear"]["w"] + tree["l_linear"]["b"]
    return torch.tanh(merged[..., 0])


def _stft_ri(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Real STFT (center-padded, Hann) -> [B, F, 2*(n_fft/2+1)] with real
    parts then imaginary parts stacked on channels (torch.stft layout after
    the upstream cat([real, imag], dim=1), transposed channels-last)."""
    frames = frame_signal(_reflect_pad(x, n_fft // 2), n_fft, hop)   # [B, F, n_fft]
    cos_b, sin_b = _dft_basis_on(x.device, n_fft, n_fft)
    return torch.cat([frames @ cos_b, frames @ sin_b], dim=-1)


def _resblock(x, p, kernel: int, dilations) -> torch.Tensor:
    for i, d in enumerate(dilations):
        h = F.leaky_relu(x, 0.1)
        h = conv1d(h, p["convs1"][str(i)], dilation=d)
        h = F.leaky_relu(h, 0.1)
        h = conv1d(h, p["convs2"][str(i)])
        x = x + h
    return x


@torch.no_grad()
def apply(
    tree: Params,
    cfg: HiFTConfig,
    mel: torch.Tensor,                   # [B, F, n_mels]
    generator: Optional[torch.Generator] = None,
    init_phase: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mel -> waveform [B, F * samples_per_frame] (iSTFT head). The
    source's draws are ``init_phase`` [B, 1, H] (radians) and ``noise``
    [B, F * samples_per_frame, H] (standard normal) when given, else
    drawn from ``generator`` (phases uniform in [0, 2 pi))."""
    B, Fr, _ = mel.shape
    f0 = f0_predict(tree["f0_predictor"], mel)               # [B, F]
    spf = cfg.samples_per_frame
    f0_up = torch.repeat_interleave(f0, spf, dim=1)          # nearest upsample
    if init_phase is None or noise is None:
        H = cfg.nb_harmonics + 1
        init_phase = torch.rand((B, 1, H), generator=generator, device=mel.device) * (2 * math.pi)
        noise = torch.randn((B, Fr * spf, H), generator=generator, device=mel.device)
    s = harmonic_source(tree["m_source"], cfg, f0_up, init_phase, noise)   # [B, F*spf]
    s_stft = _stft_ri(s, cfg.istft_n_fft, cfg.istft_hop)     # [B, F*up+1, n_fft+2]

    x = conv1d(mel, tree["conv_pre"])
    n_up = len(cfg.upsample_rates)
    for i in range(n_up):
        x = F.leaky_relu(x, 0.1)
        x = conv_transpose1d(x, tree["ups"][str(i)], stride=cfg.upsample_rates[i],
                             kernel=cfg.upsample_kernels[i])
        if i == n_up - 1:
            # upstream ReflectionPad1d((1, 0)) so x matches the center-
            # padded source STFT's +1 frame
            x = torch.cat([x[:, 1:2], x], dim=1)
        # source fusion at this stage's rate
        stride = 1
        for r in cfg.upsample_rates[i + 1:]:
            stride *= r
        sd = tree["source_downs"][str(i)]
        if stride == 1:
            si = conv1d(s_stft, sd)
        else:
            si = conv1d(s_stft, sd, stride=stride, padding=(stride // 2, stride // 2))
            si = si[:, : x.shape[1]]
        si = _resblock(si, tree["source_resblocks"][str(i)],
                       cfg.source_resblock_kernels[i], cfg.source_resblock_dilations[i])
        x = x + si[:, : x.shape[1]]
        acc = None
        nk = len(cfg.resblock_kernels)
        for j, (kern, dils) in enumerate(zip(cfg.resblock_kernels, cfg.resblock_dilations)):
            r = _resblock(x, tree["resblocks"][str(i * nk + j)], kern, dils)
            acc = r if acc is None else acc + r
        x = acc / nk
    x = F.leaky_relu(x)
    x = conv1d(x, tree["conv_post"])                          # [B, T, n_fft+2]
    n_bins = cfg.istft_n_fft // 2 + 1
    mag = torch.exp(torch.clamp(x[..., :n_bins], -20.0, math.log(1e2)))
    phase = torch.sin(x[..., n_bins:])     # upstream predicts sin(phase)
    wav = istft_overlap_add(mag * torch.cos(phase), mag * torch.sin(phase), cfg.istft_n_fft, cfg.istft_hop)
    wav = torch.clamp(wav, -0.99, 0.99)
    # drop the reflection-pad extra frame's samples; return F*spf samples
    return wav[:, : Fr * spf]
