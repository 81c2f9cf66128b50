"""MOSS-Audio-Tokenizer equivalent: the audio codec.

Ports ``mosstts_tpu/codec/model.py``: ``init_codec_params``, ``overlap_add``,
``_encode_chunk``, ``_decode_chunk``, ``CodecStreamSession`` and
``MossAudioTokenizer`` with ``random_init``, ``encode``, ``batch_encode``,
``decode`` and ``streaming()`` (same signatures; ``EncodeOutput`` and
``DecodeOutput`` of numpy arrays), so ``DelayProcessor`` consumes it
unchanged. Encode: 1920-sample frames -> linear -> causal transformer
(sliding window, chunked) -> linear -> residual VQ. Decode: RVQ sum ->
linear -> causal transformer -> RMSNorm -> linear frame head -> overlap-add
-> 24 kHz wave. Both run in chunks that carry a window of K/V, so chunked
output equals one-shot output, and inside ``streaming()`` a 2-D ``decode``
call continues the previous call's stream. The chunk programs (JAX's
``_encode_fn`` and ``_decode_fn``) run through
``engine/step_graph.CodecChunks``: on the card, CUDA graphs over static
buffers. ``from_pretrained`` and
``save_pretrained`` read and write the JAX package's codec directory
(``config.json`` and ``model.safetensors`` under the parameter tree's
names) with the port's safetensors reader and writer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.config import CodecConfig, Qwen3Config
from ..nn.qwen3 import Qwen3Params, empty_param, fill_qwen3_params_
from ..ops.basic import dense, rms_norm
from ..ops.quant import is_quantized
from .rvq import RVQParams, fill_rvq_params_, rvq_decode, rvq_encode
from .transformer import device_len, init_stream_state, run_chunk


@dataclass
class EncodeOutput:
    audio_codes: np.ndarray  # (NQ, B, T)
    audio_codes_lengths: np.ndarray  # (B,)

    def __getitem__(self, key):
        return getattr(self, key)


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


def _encode_chunk(params: CodecParams, cfg: CodecConfig, state, frames: torch.Tensor,
                  valid_len, num_quantizers: int):
    """Ports ``mosstts_tpu.codec.model._encode_chunk``: frames (B, c, hop) ->
    codes (NQ, B, c), new StreamState; ``valid_len`` the chunk's real
    frames, a () int32 tensor on the device (or an int)."""
    x = dense(frames, params.enc_in)
    h, state = run_chunk(params.encoder, _txf_cfg(cfg, cfg.num_encoder_layers), state, x,
                         valid_len)
    codes, _ = rvq_encode(params.rvq, dense(h, params.enc_out), num_quantizers)
    return codes, state


def _decode_chunk(params: CodecParams, cfg: CodecConfig, state, codes: torch.Tensor,
                  valid_len):
    """Ports ``mosstts_tpu.codec.model._decode_chunk``: codes (NQ, B, c) ->
    wave chunk (B, c*hop), new state; ``state`` = (StreamState, tail),
    ``valid_len`` as in ``_encode_chunk``."""
    txf_state, prev_tail = state
    valid_len = device_len(valid_len, codes.device)
    lat = rvq_decode(params.rvq, codes)
    x = dense(lat.to(params.dec_in.dtype), params.dec_in)
    h, txf_state = run_chunk(params.decoder, _txf_cfg(cfg, cfg.num_decoder_layers),
                             txf_state, x, valid_len)
    h = rms_norm(h, params.dec_out_norm, cfg.rms_norm_eps)
    frames = dense(h, params.dec_out)  # (B, c, hop+ov)
    wav, _ = overlap_add(frames, prev_tail, cfg.hop, cfg.overlap)
    # carry the tail of the last VALID frame (padded chunk frames are
    # garbage), picked at a clamped index on the device (JAX's
    # dynamic_index_in_dim)
    last = (valid_len - 1).clamp(0, frames.shape[1] - 1).reshape(1)
    new_tail = frames[:, :, cfg.hop:].index_select(1, last)[:, 0]
    return wav, (txf_state, new_tail)


class CodecStreamSession:
    """Ports ``mosstts_tpu.codec.model.CodecStreamSession``: the decoder
    state that the ``streaming()`` context carries across ``decode`` calls
    (K/V window, positions, cursor and overlap tail), so chunk boundaries
    are seamless. The session owns these tensors; a call copies them into
    its decode key's buffers and back (``CodecChunks.decode``)."""

    def __init__(self, codec: "MossAudioTokenizer", batch_size: int):
        self.codec = codec
        self.batch_size = batch_size
        self.state = None  # (StreamState, overlap tail)

    def reset(self):
        self.state = None


class MossAudioTokenizer:
    """Ports ``mosstts_tpu.codec.model.MossAudioTokenizer``. It runs where
    its params live. One codec may serve many threads at once: the chunk
    programs keep their static buffers per key under a lock, and the active
    ``streaming()`` session is the calling thread's own.

    Encode and decode run chunk by chunk through ``chunks``
    (``engine/step_graph.CodecChunks``, the counterpart of JAX's
    ``_encode_fn`` and ``_decode_fn``): on the card each chunk is one CUDA
    graph replay from a key's second chunk on (``graphs=False`` runs the
    same chunks eagerly; the CPU always does). ``warmup()`` captures a
    server's keys ahead of its traffic."""

    DEFAULT_CHUNK_FRAMES = 100  # 8 s at 12.5 Hz
    STREAM_CHUNK_FRAMES = 4  # engine.streaming.AudioStreamDecoder's chunks (0.32 s)

    def __init__(self, params: CodecParams, config: Optional[CodecConfig] = None, *,
                 graphs: bool = True):
        # imported here: engine/step_graph.py imports this module's chunk functions
        from ..engine.step_graph import CodecChunks

        self.config = config or CodecConfig()
        self.params = params
        self._stream_tls = threading.local()
        self.chunks = CodecChunks(self, graphs=graphs)

    @property
    def _stream(self) -> Optional[CodecStreamSession]:
        return getattr(self._stream_tls, "value", None)

    @_stream.setter
    def _stream(self, sess: Optional[CodecStreamSession]):
        self._stream_tls.value = sess

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

    @classmethod
    @torch.no_grad()
    def from_pretrained(cls, path, dtype=torch.float32, device="cuda") -> "MossAudioTokenizer":
        """Ports ``MossAudioTokenizer.from_pretrained``: the codec of a
        directory that ``save_pretrained`` (of either package) wrote, on
        ``device`` in ``dtype``."""
        from ..utils.convert import load_tree_
        from ..utils.hf_loader import load_safetensors_dir

        path = Path(path)
        if not (path / "config.json").is_file():
            raise FileNotFoundError(f"no codec (config.json) at {str(path)!r}")
        with open(path / "config.json") as f:
            cfg = CodecConfig.from_hf_dict(json.load(f))
        params = load_tree_(CodecParams(cfg, dtype=dtype, device=device),
                            dict(load_safetensors_dir(path)))
        return cls(params, cfg)

    def save_pretrained(self, path) -> None:
        """Ports ``MossAudioTokenizer.save_pretrained``: ``config.json`` and
        ``model.safetensors`` (every parameter under its tree name, in its
        own dtype)."""
        from ..utils.hf_loader import save_safetensors

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "config.json", "w") as f:
            json.dump(dataclasses.asdict(self.config), f, indent=2)
        save_safetensors({n: p.detach() for n, p in self.params.named_parameters()},
                         path / "model.safetensors")

    @property
    def encode_dtype(self) -> torch.dtype:
        """The encoder's activation dtype: an int8 encoder runs float32
        activations, as JAX's (its frames are float32 numpy;
        ``QuantWeight.dtype`` names bf16, the cache's dtype)."""
        return torch.float32 if is_quantized(self.params.enc_in) else self.params.enc_in.dtype

    def warmup(self, *, decode_levels: Optional[int] = None,
               stream_levels: Optional[int] = None) -> None:
        """Capture, ahead of traffic, the chunk programs a server runs, all
        at batch 1: an encode of ``DEFAULT_CHUNK_FRAMES`` chunks of all
        ``n_q`` levels (a cloned voice or a voice prompt); a decode of
        ``DEFAULT_CHUNK_FRAMES`` chunks of ``decode_levels`` levels (a Delay
        wave); a decode of ``STREAM_CHUNK_FRAMES`` chunks of ``stream_levels``
        levels (a Realtime stream). From then on no key is captured on use:
        one not captured here runs eagerly at every chunk, so no request
        waits for a capture."""
        self.chunks.capture_on_use = False
        keys = [("encode", self.DEFAULT_CHUNK_FRAMES, self.config.n_q)]
        if decode_levels:
            keys.append(("decode", self.DEFAULT_CHUNK_FRAMES, decode_levels))
        if stream_levels:
            keys.append(("decode", self.STREAM_CHUNK_FRAMES, stream_levels))
        for kind, cf, nq in keys:
            self.chunks.capture(kind, batch=1, chunk_frames=cf, num_quantizers=nq)

    # ------------------------------- encode --------------------------------
    @torch.no_grad()
    def _encode_array(self, wav: np.ndarray, num_quantizers: int,
                      chunk_frames: Optional[int] = None) -> np.ndarray:
        """wav (B, L) -> codes (NQ, B, T_frames) int64 numpy. The last chunk
        is zero-padded and runs with its count of real frames."""
        cfg, dev = self.config, self.device
        hop = cfg.hop
        B, L = wav.shape
        T = math.ceil(L / hop) if L else 0
        if T == 0:
            return np.zeros((num_quantizers, B, 0), np.int64)
        frames = torch.zeros((B, T * hop), dtype=torch.float32, device=dev)
        frames[:, :L] = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
        frames = frames.to(self.encode_dtype).reshape(B, T, hop)
        codes = self.chunks.encode(frames, num_quantizers,
                                   chunk_frames or self.DEFAULT_CHUNK_FRAMES)
        return codes.cpu().numpy().astype(np.int64)

    def batch_encode(self, wav_list: Sequence, num_quantizers: Optional[int] = None
                     ) -> EncodeOutput:
        """Ports ``MossAudioTokenizer.batch_encode``: waves of any lengths ->
        codes (NQ, B, T_max) and each wave's frame count."""
        nq = int(num_quantizers or self.config.n_q)
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in wav_list]
        lengths = np.array([math.ceil(len(w) / self.config.hop) for w in wavs], np.int64)
        batch = np.zeros((len(wavs), max((len(w) for w in wavs), default=0)), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        return EncodeOutput(audio_codes=self._encode_array(batch, nq),
                            audio_codes_lengths=lengths)

    def encode(self, input_values, padding_mask=None, num_quantizers: Optional[int] = None,
               return_dict: bool = True, chunk_duration: Optional[float] = None, **kw):
        """Ports ``MossAudioTokenizer.encode``: input_values (B, 1, L), (B, L)
        or (L,); ``padding_mask`` (B, L) gives each row's real samples;
        ``chunk_duration`` (seconds) sets the encoder's chunk."""
        nq = int(num_quantizers or self.config.n_q)
        arr = np.asarray(input_values, np.float32)
        if arr.ndim == 3:  # (B, 1, L)
            arr = arr[:, 0, :]
        elif arr.ndim == 1:
            arr = arr[None]
        if padding_mask is not None:
            samples = np.asarray(padding_mask, bool).sum(axis=-1)
        else:
            samples = np.full(arr.shape[0], arr.shape[1])
        lengths = np.ceil(samples / self.config.hop).astype(np.int64)
        cf = None
        if chunk_duration:
            cf = max(1, int(round(float(chunk_duration) * self.config.frame_rate)))
        out = EncodeOutput(audio_codes=self._encode_array(arr, nq, chunk_frames=cf),
                           audio_codes_lengths=lengths)
        if return_dict:
            return out
        return {"audio_codes": out.audio_codes, "audio_codes_lengths": out.audio_codes_lengths}

    # ------------------------------- decode --------------------------------
    def _init_decode_state(self, B: int):
        """Ports ``MossAudioTokenizer._init_decode_state``: an empty K/V
        window and a zero overlap tail."""
        cfg, dev, dt = self.config, self.device, self.params.dec_in.dtype
        return (init_stream_state(_txf_cfg(cfg, cfg.num_decoder_layers), B, cfg.causal_context,
                                  dtype=dt, device=dev),
                torch.zeros((B, cfg.overlap), dtype=dt, device=dev))

    @torch.no_grad()
    def _decode_array(self, codes: np.ndarray, chunk_frames: int, state=None,
                      keep_state: bool = False):
        """codes (NQ, B, T) -> wave (B, T*hop) float numpy [, final state],
        continuing from ``state`` (updated in place) when given."""
        NQ, B, T = codes.shape
        if T == 0:
            wav = np.zeros((B, 0), np.float32)
        else:
            wav = self.chunks.decode(torch.as_tensor(codes, device=self.device), chunk_frames,
                                     state).float().cpu().numpy()
        return (wav, state) if keep_state else wav

    def decode(self, audio_codes, padding_mask=None, return_dict: bool = True,
               chunk_duration: Optional[float] = 8, **kw):
        """Ports ``MossAudioTokenizer.decode``: audio_codes (NQ, B, T), or
        (NQ, T) for one stream -> ``DecodeOutput`` (audio (B, 1, L) numpy,
        audio_lengths (B,)); a (NQ, T) call returns ``{"audio": [wave]}``
        and, inside ``streaming()``, continues the previous call's stream."""
        codes = np.asarray(audio_codes, np.int64)
        squeeze = codes.ndim == 2
        if squeeze:
            codes = codes[:, None, :]
        NQ, B, T = codes.shape
        if chunk_duration is None or chunk_duration <= 0:
            cf = max(T, 1)
        else:
            cf = max(1, int(round(float(chunk_duration) * self.config.frame_rate)))

        sess = self._stream
        if sess is not None and squeeze:
            if sess.state is None:
                sess.state = self._init_decode_state(B)
            wav, sess.state = self._decode_array(codes, cf, state=sess.state, keep_state=True)
        else:
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

    @contextlib.contextmanager
    def streaming(self, batch_size: int = 1):
        """Ports ``MossAudioTokenizer.streaming``: within, successive 2-D
        ``decode`` calls of this thread continue one causal stream."""
        prev = self._stream
        self._stream = CodecStreamSession(self, batch_size)
        try:
            yield self._stream
        finally:
            self._stream = prev
