"""Codec training objective: time-domain and multi-scale spectral
reconstruction with straight-through RVQ and a commitment loss.

Ports ``mosstts_tpu/codec/losses.py``: ``stft_mag``,
``multiscale_stft_loss``, ``codec_forward_train``, ``si_snr_loss``,
``lag_align``, ``codec_loss`` and ``codec_train_step``. The STFT frames by
strided indexing (no centring, no padding: frame ``f`` starts at
``f * hop``) under ``np.hanning``'s symmetric Hann window, as JAX does;
``torch.stft`` centres and pads, and ``torch.hann_window`` is periodic by
default, so neither is used. The training forward is its own function over
the whole window (encode, RVQ with a straight-through estimator, decode,
overlap-add): the inference codec (``codec/model.py``) stays under
``torch.no_grad``. Where JAX stops gradients, the port ``detach``es.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.config import CodecConfig
from ..nn.qwen3 import qwen3_forward
from ..ops.basic import dense, rms_norm
from .model import CodecParams, _txf_cfg, overlap_add

STFT_SCALES: Sequence[Tuple[int, int]] = ((2048, 512), (1024, 256), (512, 128))


def frames_of(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, F, frame) frames at hop ``hop``, each times the
    symmetric Hann window (``np.hanning``); F = max(1, (L - frame) // hop + 1).
    A signal shorter than a frame repeats its last sample, as JAX's gather
    clamps the indices past its end."""
    L = x.shape[-1]
    n_frames = max(1, (L - frame) // hop + 1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(frame, device=x.device)[None, :]).clamp(max=L - 1)
    win = torch.as_tensor(np.hanning(frame), dtype=x.dtype, device=x.device)
    return x[:, idx] * win


def stft_mag(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """Ports ``stft_mag``: |STFT| of (B, L) -> (B, F, frame // 2 + 1)."""
    return torch.fft.rfft(frames_of(x, frame, hop), dim=-1).abs()


def multiscale_stft_loss(x: torch.Tensor, y: torch.Tensor, scales=STFT_SCALES) -> torch.Tensor:
    """Ports ``multiscale_stft_loss``: the sum over the scales that fit of
    spectral convergence plus the mean log-magnitude L1."""
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for frame, hop in scales:
        if x.shape[-1] < frame:
            continue
        mx, my = stft_mag(x, frame, hop), stft_mag(y, frame, hop)
        sc = torch.linalg.vector_norm(mx - my) / (torch.linalg.vector_norm(mx) + 1e-6)
        mag = (torch.log(mx + 1e-5) - torch.log(my + 1e-5)).abs().mean()
        loss = loss + sc + mag
    return loss


def codec_forward_train(params: CodecParams, cfg: CodecConfig, wav: torch.Tensor,
                        num_quantizers: int):
    """Ports ``codec_forward_train``: the whole window (B, T * hop) encoded,
    quantized level by level (the argmin of ``|c|^2 - 2 r.c``, its dot
    products in float64 rounded once to float32, as ``rvq.rvq_encode``),
    passed straight through (``latents + (quantized - latents).detach()``)
    and decoded. Returns (recon (B, T * hop), {"commitment", "codebook"})."""
    B, L = wav.shape
    hop = cfg.hop
    T = L // hop
    frames = wav[:, : T * hop].reshape(B, T, hop)
    dev = wav.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    ones = torch.ones((B, T), dtype=torch.bool, device=dev)

    h, _ = qwen3_forward(params.encoder, _txf_cfg(cfg, cfg.num_encoder_layers),
                         dense(frames, params.enc_in), positions=positions, kv_valid=ones,
                         attn_window=cfg.causal_context)
    latents = dense(h, params.enc_out).float()

    books = params.rvq.codebooks[:num_quantizers].float()
    residual = latents
    for book in books:
        dots = torch.matmul(residual.detach().double(), book.detach().double().T).float()
        codes = ((book.detach() * book.detach()).sum(-1) - 2.0 * dots).argmin(-1)
        residual = residual - book[codes]
    quantized = latents - residual  # the sum of the chosen codebook vectors
    commitment = ((latents - quantized.detach()) ** 2).mean()
    codebook_loss = ((latents.detach() - quantized) ** 2).mean()
    quantized_st = latents + (quantized - latents).detach()

    y = dense(quantized_st.to(params.dec_in.dtype), params.dec_in)
    h, _ = qwen3_forward(params.decoder, _txf_cfg(cfg, cfg.num_decoder_layers), y,
                         positions=positions, kv_valid=ones, attn_window=cfg.causal_context)
    h = rms_norm(h, params.dec_out_norm, cfg.rms_norm_eps)
    frames_out = dense(h, params.dec_out)  # (B, T, hop + ov)
    recon, _ = overlap_add(frames_out, frames_out.new_zeros((B, cfg.overlap)), hop, cfg.overlap)
    return recon, {"commitment": commitment, "codebook": codebook_loss}


def si_snr_loss(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Ports ``si_snr_loss``: the negative scale-invariant SNR in dB, the
    batch mean."""
    est = est - est.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    proj = ((est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = (proj * proj).sum(-1) / ((noise * noise).sum(-1) + eps)
    return -(10.0 * torch.log10(ratio + eps)).mean()


def lag_align(est: torch.Tensor, ref: torch.Tensor, max_shift: int = 96, hop: int = 8):
    """Ports ``lag_align``: each row's best constant lag of ``est`` against
    ``ref`` among every ``hop`` samples in [-max_shift, max_shift] (and
    max_shift itself), chosen by SI-SNR, the choice detached. Returns
    (est aligned, ref's centre), both n - 2 * max_shift long."""
    n = min(est.shape[-1], ref.shape[-1])
    est, ref = est[..., :n], ref[..., :n]
    ms = max_shift
    lags = list(range(-ms, ms + 1, hop))
    if lags[-1] != ms:
        lags.append(ms)
    ref_c = ref[..., ms: n - ms]
    cands = torch.stack([est[..., ms + k: n - ms + k] for k in lags])  # (L, B, T)
    rz = ref_c - ref_c.mean(-1, keepdim=True)
    ez = cands - cands.mean(-1, keepdim=True)
    proj = ((ez * rz).sum(-1, keepdim=True) / ((rz * rz).sum(-1, keepdim=True) + 1e-8)) * rz
    noise = ez - proj
    score = (proj * proj).sum(-1) / ((noise * noise).sum(-1) + 1e-8)  # (L, B)
    idx = score.detach().argmax(0)  # (B,)
    est_a = cands.gather(0, idx[None, :, None].expand(1, *cands.shape[1:]))[0]
    return est_a, ref_c


def reconstruction_terms(recon: torch.Tensor, wav: torch.Tensor, lag_tolerance: int = 0):
    """The waveform and spectral terms both codec steps share: (recon f32,
    target f32, l1, stft, neg_si_snr), after ``lag_align`` when
    ``lag_tolerance`` > 0."""
    target = wav[:, : recon.shape[1]].float()
    reconf = recon.float()
    if lag_tolerance > 0:
        reconf, target = lag_align(reconf, target, max_shift=lag_tolerance)
    l1 = (reconf - target).abs().mean()
    return reconf, target, l1, multiscale_stft_loss(target, reconf), si_snr_loss(reconf, target)


def codec_loss(params: CodecParams, cfg: CodecConfig, wav: torch.Tensor,
               num_quantizers: int = 8, commit_weight: float = 0.25,
               stft_weight: float = 1.0, l1_weight: float = 1.0,
               snr_weight: float = 1.0, lag_tolerance: int = 0):
    """Ports ``codec_loss``: (total, {"l1", "stft", "neg_si_snr_db",
    "commitment", "codebook"})."""
    recon, aux = codec_forward_train(params, cfg, wav, num_quantizers)
    _, _, l1, spec, neg_snr = reconstruction_terms(recon, wav, lag_tolerance)
    total = (l1_weight * l1 + stft_weight * spec + snr_weight * neg_snr
             + commit_weight * aux["commitment"] + aux["codebook"])
    return total, {"l1": l1, "stft": spec, "neg_si_snr_db": neg_snr, **aux}


def codec_train_step(params: CodecParams, cfg: CodecConfig, wav: torch.Tensor, *,
                     num_quantizers: int = 8, lr: float = 1e-4):
    """Ports ``codec_train_step``: one SGD step ``p - lr * g`` over
    ``codec_loss``, in place. Returns (params, loss, aux)."""
    from ..train.optim import value_and_grad

    loss, aux, grads = value_and_grad(params, lambda p: codec_loss(p, cfg, wav, num_quantizers))
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.sub_(lr * grads[name].to(p.dtype))
    return params, loss, aux
