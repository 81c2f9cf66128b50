"""Backend loading for the serving layer.

Ports ``mosstts_tpu/serve/backend.py``: ``load_codec``,
``load_delay_backend``, ``load_local_backend`` and
``load_realtime_backend``, on ``device`` (the card unless the caller asks
for the CPU). A backend comes from a checkpoint directory (``model_path``:
``config.json`` and safetensors shards in the reference's layout, read by
``utils/checkpoints.py``, and the directory's tokenizer; ``codec_path``: a
codec directory ``save_pretrained`` wrote), or, with no path, from random
demo weights (a tiny backbone, the demo codec, the offline byte tokenizer)
so every pipeline runs without a checkpoint. The engines run in
``dtype_str`` (bf16 by default), the codec in float32.

Differences from the JAX package, by design: a path that does not exist
raises ``FileNotFoundError`` (JAX silently serves the random demo model
then, so a typo would serve random weights); the directory's
``tokenizer.json`` is read by the port's own reader
(``processing/bpe.Qwen2BPETokenizer``, no ``transformers``), which raises on
a file it cannot take, and a directory with only ``vocab.json`` and
``merges.txt`` raises ``FileNotFoundError``, where JAX falls back to the
byte tokenizer on any failure of ``transformers``; a directory with no
tokenizer files gives the byte fallback, as in JAX, with a warning.
``load_local_backend`` returns a ``DelayBackend`` over a
``LocalEngine``, as JAX does; the pipelines' ``synthesize`` passes keywords
``LocalEngine.generate`` does not take, so it raises ``TypeError`` over that
backend in both packages.
"""
from __future__ import annotations

import functools
import logging
from typing import Optional

import torch

from ..codec.model import MossAudioTokenizer
from ..core.config import (CodecConfig, DelayConfig, LocalConfig, RealtimeConfig,
                           RealtimeLocalConfig, tiny_qwen3)
from ..engine.delay_engine import DelayEngine
from ..engine.local_engine import LocalEngine
from ..engine.realtime_engine import RealtimeEngine
from ..processing.delay_processor import DelayProcessor
from ..processing.local_processor import LocalProcessor
from ..processing.realtime_processor import RealtimeProcessor
from ..processing.tokenizer import ByteFallbackTokenizer, load_tokenizer
from .pipelines import DelayBackend

_DEMO_CODEC = CodecConfig(
    n_q=32, codebook_size=1024, codebook_dim=16, hidden_size=64,
    intermediate_size=128, num_encoder_layers=2, num_decoder_layers=2,
    num_attention_heads=4, num_key_value_heads=4, head_dim=16, causal_context=32,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _tokenizer(model_path: str):
    """The checkpoint directory's tokenizer (``load_tokenizer``), logged."""
    tok = load_tokenizer(model_path)
    log = logging.getLogger(__name__)
    if isinstance(tok, ByteFallbackTokenizer):
        log.warning("%s: no tokenizer files (tokenizer.json) in the directory; using the byte "
                    "fallback tokenizer", model_path)
    else:
        log.info("%s: tokenizer %s", model_path, type(tok).__name__)
    return tok


def load_codec(codec_path: Optional[str] = None, dtype=torch.float32,
               device="cuda") -> MossAudioTokenizer:
    """Ports ``mosstts_tpu.serve.backend.load_codec``: the codec of the
    directory ``codec_path``, else the demo codec with random weights from
    seed 0, on ``device``."""
    if codec_path:
        return MossAudioTokenizer.from_pretrained(codec_path, dtype=dtype, device=device)
    return MossAudioTokenizer.random_init(seed=0, config=_DEMO_CODEC, dtype=dtype, device=device)


@functools.lru_cache(maxsize=2)
def load_delay_backend(
    model_path: Optional[str] = None,
    codec_path: Optional[str] = None,
    dtype_str: str = "bfloat16",
    device: str = "cuda",
) -> DelayBackend:
    """Ports ``mosstts_tpu.serve.backend.load_delay_backend``: the Delay
    checkpoint at ``model_path`` (``load_delay_checkpoint``), else a tiny
    demo engine from seed 0, in ``dtype_str``, and the codec, on
    ``device``. One backend per argument tuple is kept for the process, as
    in the JAX package. The codec's chunk programs are captured here, ahead
    of traffic (``MossAudioTokenizer.warmup``: encode and decode at batch 1
    in 100-frame chunks)."""
    from ..utils.checkpoints import load_delay_checkpoint

    codec = load_codec(codec_path, device=device)
    dtype = _DTYPES[dtype_str]
    if model_path:
        params, cfg = load_delay_checkpoint(model_path, dtype, device)
        engine = DelayEngine(params, cfg, dtype=dtype, device=device)
        tokenizer = _tokenizer(model_path)
    else:
        cfg = DelayConfig(language_config=tiny_qwen3(hidden_size=128), n_vq=_DEMO_CODEC.n_q)
        engine = DelayEngine.random_init(seed=0, config=cfg, dtype=dtype, device=device)
        tokenizer = ByteFallbackTokenizer()
    proc = DelayProcessor(tokenizer, audio_tokenizer=codec, config=cfg)
    codec.warmup(decode_levels=cfg.n_vq)  # a cloned voice's encode, a wave's decode
    return DelayBackend(engine=engine, processor=proc, sample_rate=cfg.sampling_rate,
                        demo=not model_path)


@functools.lru_cache(maxsize=2)
def load_local_backend(
    model_path: Optional[str] = None,
    codec_path: Optional[str] = None,
    dtype_str: str = "bfloat16",
    device: str = "cuda",
) -> DelayBackend:
    """Ports ``mosstts_tpu.serve.backend.load_local_backend``: the Local
    checkpoint at ``model_path`` (``load_local_checkpoint``), else JAX's demo
    config (a tiny backbone, 32 codebooks, a 2-layer depth transformer of
    width 48) from seed 0, in ``dtype_str``, and the codec, on ``device``;
    a ``DelayBackend`` over a ``LocalEngine`` with a ``LocalProcessor``; its
    codec warmed up as ``load_delay_backend``'s."""
    from ..utils.checkpoints import load_local_checkpoint

    codec = load_codec(codec_path, device=device)
    dtype = _DTYPES[dtype_str]
    if model_path:
        params, cfg = load_local_checkpoint(model_path, dtype, device)
        engine = LocalEngine(params, cfg, dtype=dtype, device=device)
        tokenizer = _tokenizer(model_path)
    else:
        cfg = LocalConfig(
            language_config=tiny_qwen3(hidden_size=128), n_vq=_DEMO_CODEC.n_q,
            additional_mlp_ffn_hidden_size=64, local_ffn_hidden_size=96,
            local_hidden_size=48, local_num_layers=2)
        engine = LocalEngine.random_init(seed=0, config=cfg, dtype=dtype, device=device)
        tokenizer = ByteFallbackTokenizer()
    proc = LocalProcessor(tokenizer, audio_tokenizer=codec, config=cfg)
    codec.warmup(decode_levels=cfg.n_vq)
    return DelayBackend(engine=engine, processor=proc, sample_rate=cfg.sampling_rate)


@functools.lru_cache(maxsize=2)
def load_realtime_backend(
    model_path: Optional[str] = None,
    codec_path: Optional[str] = None,
    dtype_str: str = "bfloat16",
    device: str = "cuda",
):
    """Ports ``mosstts_tpu.serve.backend.load_realtime_backend``:
    ``(engine, processor, codec)``, the Realtime checkpoint at
    ``model_path`` (``load_realtime_checkpoint``), else a tiny demo engine
    (16 codebooks, half the demo codec's) from seed 0, in ``dtype_str``, and
    the codec, on ``device``. One backend per argument tuple is kept for the
    process. The codec's chunk programs are captured here (a batch-1 encode
    in 100-frame chunks, the stream's 4-frame decode chunks of ``rvq``
    levels)."""
    from ..utils.checkpoints import load_realtime_checkpoint

    codec = load_codec(codec_path, device=device)
    dtype = _DTYPES[dtype_str]
    if model_path:
        params, cfg = load_realtime_checkpoint(model_path, dtype, device)
        engine = RealtimeEngine(params, cfg, dtype=dtype, device=device)
        tokenizer = _tokenizer(model_path)
    else:
        cfg = RealtimeConfig(
            language_config=tiny_qwen3(hidden_size=64),
            local_config=RealtimeLocalConfig(
                hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                rvq=_DEMO_CODEC.n_q // 2),
            rvq=_DEMO_CODEC.n_q // 2)
        engine = RealtimeEngine.random_init(seed=0, config=cfg, dtype=dtype, device=device)
        tokenizer = ByteFallbackTokenizer()
    codec.warmup(stream_levels=cfg.rvq)  # a voice prompt's encode, the stream's chunks
    return engine, RealtimeProcessor(tokenizer, channels=cfg.rvq), codec
