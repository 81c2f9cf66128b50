"""MOSS-Audio-Tokenizer equivalent: the decode path of the audio codec.

Ports ``mosstts_tpu/codec/model.py``: ``init_codec_params``,
``overlap_add``, ``_decode_chunk`` and ``MossAudioTokenizer`` with
``random_init`` and ``decode`` (same signature, ``DecodeOutput`` of numpy
arrays), so ``DelayProcessor.decode_audio_codes`` consumes it unchanged.
Decode path: RVQ sum -> linear -> causal transformer (sliding window,
chunked) -> RMSNorm -> linear frame head -> overlap-add -> 24 kHz wave.
Encode, ``streaming()`` and ``from_pretrained`` are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.config import CodecConfig, Qwen3Config
from ..nn.qwen3 import Qwen3Params, empty_param, fill_qwen3_params_
from ..ops.basic import dense, rms_norm
from .rvq import RVQParams, fill_rvq_params_, rvq_decode
from .transformer import init_stream_state, run_chunk


@dataclass
class DecodeOutput:
    audio: np.ndarray  # (B, 1, L)
    audio_lengths: np.ndarray  # (B,)

    def __getitem__(self, key):
        return getattr(self, key)


def _txf_cfg(cfg: CodecConfig, n_layers: int) -> Qwen3Config:
    return Qwen3Config(
        vocab_size=1, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=n_layers, num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
    )


class CodecParams(nn.Module):
    """Ports the ``init_codec_params`` pytree (encoder weights included, so
    the names match the JAX tree one to one)."""

    def __init__(self, cfg: CodecConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        D, hop, dlat = cfg.hidden_size, cfg.hop, cfg.codebook_dim
        self.enc_in = empty_param((hop, D), dtype, device)
        self.encoder = Qwen3Params(_txf_cfg(cfg, cfg.num_encoder_layers), dtype=dtype,
                                   device=device, with_embed=False)
        self.enc_out = empty_param((D, dlat), dtype, device)
        self.rvq = RVQParams(cfg.n_q, cfg.codebook_size, dlat, dtype=dtype, device=device)
        self.dec_in = empty_param((dlat, D), dtype, device)
        self.decoder = Qwen3Params(_txf_cfg(cfg, cfg.num_decoder_layers), dtype=dtype,
                                   device=device, with_embed=False)
        self.dec_out_norm = empty_param((D,), dtype, device)
        self.dec_out = empty_param((D, hop + cfg.overlap), dtype, device)


@torch.no_grad()
def init_codec_params(cfg: CodecConfig, *, generator: torch.Generator, dtype=torch.float32,
                      device=None) -> CodecParams:
    """Ports ``mosstts_tpu.codec.model.init_codec_params``, drawing on
    ``device``."""
    p = CodecParams(cfg, dtype=dtype, device=device)
    p.enc_in.normal_(0.0, 1.0 / math.sqrt(cfg.hop), generator=generator)
    fill_qwen3_params_(p.encoder, generator)
    p.enc_out.normal_(0.0, 0.02, generator=generator)
    fill_rvq_params_(p.rvq, generator)
    p.dec_in.normal_(0.0, 0.02, generator=generator)
    fill_qwen3_params_(p.decoder, generator)
    p.dec_out_norm.fill_(1.0)
    p.dec_out.normal_(0.0, 0.02, generator=generator)
    return p


def overlap_add(frames: torch.Tensor, prev_tail: torch.Tensor, hop: int, ov: int):
    """Ports ``mosstts_tpu.codec.model.overlap_add``: frames (B, c, hop+ov),
    prev_tail (B, ov) -> (wave (B, c*hop), new tail (B, ov)); each frame's
    head crossfades linearly with the preceding frame's tail."""
    B, c, _ = frames.shape
    heads, tails = frames[:, :, :hop], frames[:, :, hop:]
    prev = torch.cat([prev_tail[:, None, :], tails[:, :-1, :]], dim=1)
    w = ((torch.arange(ov, dtype=torch.float32, device=frames.device) + 1.0)
         / (ov + 1.0)).to(frames.dtype)
    blended = heads[:, :, :ov] * w + prev * (1.0 - w)
    heads = torch.cat([blended, heads[:, :, ov:]], dim=-1)
    return heads.reshape(B, c * hop), tails[:, -1, :]


def _decode_chunk(params: CodecParams, cfg: CodecConfig, state, codes: torch.Tensor,
                  valid_len: int):
    """Ports ``mosstts_tpu.codec.model._decode_chunk``: codes (NQ, B, c) ->
    wave chunk (B, c*hop), new state; ``state`` = (StreamState, tail)."""
    txf_state, prev_tail = state
    lat = rvq_decode(params.rvq, codes)
    x = dense(lat.to(params.dec_in.dtype), params.dec_in)
    h, txf_state = run_chunk(params.decoder, _txf_cfg(cfg, cfg.num_decoder_layers),
                             txf_state, x, valid_len)
    h = rms_norm(h, params.dec_out_norm, cfg.rms_norm_eps)
    frames = dense(h, params.dec_out)  # (B, c, hop+ov)
    wav, _ = overlap_add(frames, prev_tail, cfg.hop, cfg.overlap)
    # carry the tail of the last VALID frame (padded chunk frames are garbage)
    c = frames.shape[1]
    new_tail = frames[:, min(max(valid_len - 1, 0), c - 1), cfg.hop:]
    return wav, (txf_state, new_tail)


class MossAudioTokenizer:
    """Ports ``mosstts_tpu.codec.model.MossAudioTokenizer`` (decode only)."""

    def __init__(self, params: CodecParams, config: Optional[CodecConfig] = None):
        self.config = config or CodecConfig()
        self.params = params

    @property
    def codebook_size(self) -> int:
        return self.config.codebook_size

    @property
    def sampling_rate(self) -> int:
        return self.config.sampling_rate

    @property
    def frame_rate(self) -> float:
        return self.config.frame_rate

    @property
    def device(self) -> torch.device:
        return self.params.dec_in.device

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[CodecConfig] = None,
                    dtype=torch.float32, device="cuda") -> "MossAudioTokenizer":
        """Random weights drawn directly on ``device`` from ``seed``."""
        config = config or CodecConfig()
        gen = torch.Generator(device=device).manual_seed(seed)
        return cls(init_codec_params(config, generator=gen, dtype=dtype, device=device), config)

    def _decode_array(self, codes: np.ndarray, chunk_frames: int) -> np.ndarray:
        """codes (NQ, B, T) -> wave (B, T*hop) float numpy."""
        cfg, dev = self.config, self.device
        NQ, B, T = codes.shape
        dt = self.params.dec_in.dtype
        state = (init_stream_state(_txf_cfg(cfg, cfg.num_decoder_layers), B,
                                   cfg.causal_context, dtype=dt, device=dev),
                 torch.zeros((B, cfg.overlap), dtype=dt, device=dev))
        codes_dev = torch.as_tensor(codes, device=dev)
        outs = []
        for start in range(0, T, chunk_frames):
            chunk = codes_dev[:, :, start:start + chunk_frames]
            vlen = chunk.shape[2]
            if vlen < chunk_frames:
                chunk = torch.nn.functional.pad(chunk, (0, chunk_frames - vlen))
            wav_chunk, state = _decode_chunk(self.params, cfg, state, chunk, vlen)
            outs.append(wav_chunk[:, : vlen * cfg.hop])
        if not outs:
            return np.zeros((B, 0), np.float32)
        return torch.cat(outs, dim=1).float().cpu().numpy()

    @torch.no_grad()
    def decode(self, audio_codes, padding_mask=None, return_dict: bool = True,
               chunk_duration: Optional[float] = 8, **kw):
        """Ports ``MossAudioTokenizer.decode``: audio_codes (NQ, B, T), or
        (NQ, T) for one stream -> ``DecodeOutput`` (audio (B, 1, L) numpy,
        audio_lengths (B,))."""
        codes = np.asarray(audio_codes, np.int64)
        squeeze = codes.ndim == 2
        if squeeze:
            codes = codes[:, None, :]
        NQ, B, T = codes.shape
        if chunk_duration is None or chunk_duration <= 0:
            cf = max(T, 1)
        else:
            cf = max(1, int(round(float(chunk_duration) * self.config.frame_rate)))
        wav = self._decode_array(codes, cf)

        if padding_mask is not None:
            frame_lengths = np.asarray(padding_mask, bool).sum(axis=-1)
        else:
            frame_lengths = np.full(B, T)
        audio_lengths = (frame_lengths * self.config.hop).astype(np.int64)
        if squeeze:
            return {"audio": [wav[0]], "audio_lengths": audio_lengths}
        out = DecodeOutput(audio=wav[:, None, :], audio_lengths=audio_lengths)
        if return_dict:
            return out
        return {"audio": out.audio, "audio_lengths": out.audio_lengths}
