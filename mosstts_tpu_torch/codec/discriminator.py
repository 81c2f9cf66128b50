"""Adversarial discriminators for codec training: multi-scale STFT and
multi-period.

Ports ``mosstts_tpu/codec/discriminator.py``: ``init_discriminators``
(``init_msstft_disc``, ``init_mpd_disc``), ``msstft_disc_forward``,
``mpd_disc_forward``, ``disc_forward``, ``hinge_d_loss``, ``hinge_g_loss``
and ``feature_matching_loss``. An EnCodec-style conv stack over each
scale's complex STFT (real and imaginary channels) and a HiFi-GAN
multi-period stack over the waveform folded by each prime period.

The weights keep the JAX tree's names (``msstft.subs.<i>.in``,
``.mid.<j>``, ``.pre_out``, ``.out``; ``mpd.subs.<i>.stack.<j>``, ...) and
its HWIO layout (kh, kw, in, out), so ``utils.convert.load_tree_`` loads a
JAX ``init_discriminators`` tree one to one; ``conv_same`` permutes a
weight to PyTorch's OIHW at the call. Activations run as NCHW (JAX's are
NHWC); a feature map here is JAX's with its channel axis moved to 1.
JAX's ``padding="SAME"`` with strides is TF/XLA SAME: per axis the total
padding is ``max((ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)``, the
smaller half in front. ``F.conv2d(padding="same")`` refuses strides, so
``conv_same`` pads explicitly.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .losses import frames_of

MSSTFT_SCALES: Sequence[Tuple[int, int]] = ((2048, 512), (1024, 256), (512, 128), (256, 64))
MPD_PERIODS: Sequence[int] = (2, 3, 5, 7, 11)
_LRELU_SLOPE = 0.1

DiscOut = List[Tuple[torch.Tensor, List[torch.Tensor]]]


def same_padding(n: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """TF/XLA SAME padding of one axis of length ``n``: (front, back)."""
    total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int],
              dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """JAX ``_conv``: NCHW ``x`` by an HWIO weight, SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = same_padding(x.shape[2], kh, stride[0], dilation[0])
    pw = same_padding(x.shape[3], kw, stride[1], dilation[1])
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride, dilation=dilation)


def _hwio(kh: int, kw: int, cin: int, cout: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((kh, kw, cin, cout), dtype=dtype, device=device),
                        requires_grad=False)


class MSSTFTSub(nn.Module):
    """One scale's stack: ``in`` (3, 9, 2, C), ``mid`` three (3, 9, C, C),
    ``pre_out`` (3, 3, C, C), ``out`` (3, 3, C, 1)."""

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        self.register_parameter("in", _hwio(3, 9, 2, channels, dtype, device))
        self.mid = nn.ParameterList([_hwio(3, 9, channels, channels, dtype, device)
                                     for _ in range(3)])
        self.pre_out = _hwio(3, 3, channels, channels, dtype, device)
        self.out = _hwio(3, 3, channels, 1, dtype, device)


class MPDSub(nn.Module):
    """One period's stack: ``stack`` (5, 1, c_j, c_j+1) for c = 1, C, 2C,
    4C, ``pre_out`` (5, 1, 4C, 4C), ``out`` (3, 1, 4C, 1)."""

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        chs = [1, channels, channels * 2, channels * 4]
        self.stack = nn.ParameterList([_hwio(5, 1, chs[j], chs[j + 1], dtype, device)
                                       for j in range(3)])
        self.pre_out = _hwio(5, 1, chs[-1], chs[-1], dtype, device)
        self.out = _hwio(3, 1, chs[-1], 1, dtype, device)


class SubStacks(nn.Module):
    """``subs``: one stack per scale or period (the JAX ``{"subs": [...]}``)."""

    def __init__(self, subs: List[nn.Module]):
        super().__init__()
        self.subs = nn.ModuleList(subs)


class Discriminators(nn.Module):
    """Ports the ``init_discriminators`` tree: ``msstft`` and/or ``mpd``."""

    def __init__(self, *, channels: int = 32, use_msstft: bool = True, use_mpd: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        if use_msstft:
            self.msstft = SubStacks([MSSTFTSub(channels, dtype, device) for _ in MSSTFT_SCALES])
        if use_mpd:
            self.mpd = SubStacks([MPDSub(channels, dtype, device) for _ in MPD_PERIODS])


@torch.no_grad()
def init_discriminators(*, generator: torch.Generator, channels: int = 32,
                        use_msstft: bool = True, use_mpd: bool = True, dtype=torch.float32,
                        device=None) -> Discriminators:
    """Ports ``init_discriminators``, drawing on ``device``: each weight
    uniform in +-1/sqrt(kh * kw * in). The draws differ from JAX's; parity
    tests load JAX weights through ``utils.convert``."""
    d = Discriminators(channels=channels, use_msstft=use_msstft, use_mpd=use_mpd, dtype=dtype,
                       device=device)
    for p in d.parameters():
        kh, kw, cin, _ = p.shape
        scale = 1.0 / np.sqrt(kh * kw * cin)
        p.uniform_(-scale, scale, generator=generator)
    return d


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _LRELU_SLOPE)


def stft_complex(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """Ports ``_stft_complex``: (B, L) -> (B, 2, F, bins), the real and
    imaginary parts of the Hann STFT as channels (NCHW)."""
    spec = torch.fft.rfft(frames_of(x, frame, hop), dim=-1)  # (B, F, bins)
    return torch.stack([spec.real, spec.imag], dim=1).to(x.dtype)


def msstft_disc_forward(params: SubStacks, wav: torch.Tensor,
                        scales: Sequence[Tuple[int, int]] = MSSTFT_SCALES) -> DiscOut:
    """Ports ``msstft_disc_forward``: per scale that fits, (logit map,
    [feature maps]), NCHW."""
    outs = []
    for sub, (frame, hop) in zip(params.subs, scales):
        if wav.shape[-1] < frame:
            continue
        h = _lrelu(conv_same(stft_complex(wav, frame, hop), getattr(sub, "in"), (1, 2)))
        feats = [h]
        for j, w in enumerate(sub.mid):
            h = _lrelu(conv_same(h, w, (1, 2), dilation=(2 ** j, 1)))
            feats.append(h)
        h = _lrelu(conv_same(h, sub.pre_out, (1, 1)))
        feats.append(h)
        outs.append((conv_same(h, sub.out, (1, 1)), feats))
    return outs


def mpd_disc_forward(params: SubStacks, wav: torch.Tensor,
                     periods: Sequence[int] = MPD_PERIODS) -> DiscOut:
    """Ports ``mpd_disc_forward``: the waveform reflect-padded to a multiple
    of each period and folded to (B, 1, L / p, p)."""
    B, L = wav.shape
    outs = []
    for sub, p in zip(params.subs, periods):
        Lp = ((L + p - 1) // p) * p
        x = F.pad(wav[:, None], (0, Lp - L), mode="reflect")
        h = x.reshape(B, 1, Lp // p, p)
        feats = []
        for w in sub.stack:
            h = _lrelu(conv_same(h, w, (3, 1)))
            feats.append(h)
        h = _lrelu(conv_same(h, sub.pre_out, (1, 1)))
        feats.append(h)
        outs.append((conv_same(h, sub.out, (1, 1)), feats))
    return outs


def disc_forward(params: Discriminators, wav: torch.Tensor) -> DiscOut:
    """Ports ``disc_forward``: the MS-STFT outputs, then the MPD outputs."""
    outs: DiscOut = []
    if hasattr(params, "msstft"):
        outs.extend(msstft_disc_forward(params.msstft, wav))
    if hasattr(params, "mpd"):
        outs.extend(mpd_disc_forward(params.mpd, wav))
    return outs


def hinge_d_loss(real_outs: DiscOut, fake_outs: DiscOut) -> torch.Tensor:
    """Ports ``hinge_d_loss``: the mean over sub-discriminators of
    mean(relu(1 - real)) + mean(relu(1 + fake))."""
    loss = 0.0
    for (lr_, _), (lf, _) in zip(real_outs, fake_outs):
        loss = loss + F.relu(1.0 - lr_).mean() + F.relu(1.0 + lf).mean()
    return loss / max(1, len(real_outs))


def hinge_g_loss(fake_outs: DiscOut) -> torch.Tensor:
    """Ports ``hinge_g_loss``: minus the mean fake logit, averaged."""
    loss = 0.0
    for lf, _ in fake_outs:
        loss = loss - lf.mean()
    return loss / max(1, len(fake_outs))


def feature_matching_loss(real_outs: DiscOut, fake_outs: DiscOut) -> torch.Tensor:
    """Ports ``feature_matching_loss``: L1 between the feature maps on real
    and on generated audio, each divided by the real map's mean magnitude
    (EnCodec's relative feature matching), averaged over the maps."""
    loss = 0.0
    n = 0
    for (_, fr), (_, ff) in zip(real_outs, fake_outs):
        for r, f in zip(fr, ff):
            loss = loss + (r - f).abs().mean() / (r.abs().mean() + 1e-5)
            n += 1
    return loss / max(1, n)
