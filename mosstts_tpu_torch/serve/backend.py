"""Backend loading for the serving layer.

Ports ``mosstts_tpu/serve/backend.py`` in its demo mode: ``load_codec``,
``load_delay_backend`` and ``load_realtime_backend`` build random-weight
models (a tiny backbone, the demo codec, the offline byte tokenizer) on
``device``, the card unless the caller asks for the CPU, so every pipeline
runs without a checkpoint. The engines run in ``dtype_str`` (bf16 by
default), the codec in float32. Checkpoint directories (``model_path``,
``codec_path``) wait for the checkpoint loaders (ROADMAP A.7), and the
Local backend for its family (ROADMAP A.9): those raise
``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..codec.model import MossAudioTokenizer
from ..core.config import (CodecConfig, DelayConfig, RealtimeConfig, RealtimeLocalConfig,
                           tiny_qwen3)
from ..engine.delay_engine import DelayEngine
from ..engine.realtime_engine import RealtimeEngine
from ..processing.delay_processor import DelayProcessor
from ..processing.realtime_processor import RealtimeProcessor
from ..processing.tokenizer import ByteFallbackTokenizer
from .pipelines import DelayBackend

_DEMO_CODEC = CodecConfig(
    n_q=32, codebook_size=1024, codebook_dim=16, hidden_size=64,
    intermediate_size=128, num_encoder_layers=2, num_decoder_layers=2,
    num_attention_heads=4, num_key_value_heads=4, head_dim=16, causal_context=32,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _no_checkpoints(what: str, path: str):
    raise NotImplementedError(
        f"{what} {path!r}: loading checkpoints is not ported yet (ROADMAP A.7); "
        "leave it unset for the random-weight demo backend")


def load_codec(codec_path: Optional[str] = None, dtype=torch.float32,
               device="cuda") -> MossAudioTokenizer:
    """Ports ``mosstts_tpu.serve.backend.load_codec``: the demo codec with
    random weights from seed 0 on ``device``."""
    if codec_path:
        _no_checkpoints("codec_path", codec_path)
    return MossAudioTokenizer.random_init(seed=0, config=_DEMO_CODEC, dtype=dtype, device=device)


@functools.lru_cache(maxsize=2)
def load_delay_backend(
    model_path: Optional[str] = None,
    codec_path: Optional[str] = None,
    dtype_str: str = "bfloat16",
    device: str = "cuda",
) -> DelayBackend:
    """Ports ``mosstts_tpu.serve.backend.load_delay_backend`` (demo mode):
    a tiny Delay engine in ``dtype_str`` and the demo codec in float32, both
    from seed 0 on ``device``. One backend per argument tuple is kept for
    the process, as in the JAX package."""
    if model_path:
        _no_checkpoints("model_path", model_path)
    codec = load_codec(codec_path, device=device)
    cfg = DelayConfig(language_config=tiny_qwen3(hidden_size=128), n_vq=_DEMO_CODEC.n_q)
    engine = DelayEngine.random_init(seed=0, config=cfg, dtype=_DTYPES[dtype_str],
                                     device=device)
    proc = DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=codec, config=cfg)
    return DelayBackend(engine=engine, processor=proc, sample_rate=cfg.sampling_rate, demo=True)


def load_local_backend(*args, **kwargs):
    """``mosstts_tpu.serve.backend.load_local_backend``: not ported yet."""
    raise NotImplementedError("the Local family is not ported yet (ROADMAP A.9)")


@functools.lru_cache(maxsize=2)
def load_realtime_backend(
    model_path: Optional[str] = None,
    codec_path: Optional[str] = None,
    dtype_str: str = "bfloat16",
    device: str = "cuda",
):
    """Ports ``mosstts_tpu.serve.backend.load_realtime_backend`` (demo
    mode): ``(engine, processor, codec)``, a tiny Realtime engine (16
    codebooks, half the demo codec's) in ``dtype_str`` and the demo codec
    in float32, both from seed 0 on ``device``. One backend per argument
    tuple is kept for the process."""
    if model_path:
        _no_checkpoints("model_path", model_path)
    codec = load_codec(codec_path, device=device)
    cfg = RealtimeConfig(
        language_config=tiny_qwen3(hidden_size=64),
        local_config=RealtimeLocalConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            rvq=_DEMO_CODEC.n_q // 2),
        rvq=_DEMO_CODEC.n_q // 2)
    engine = RealtimeEngine.random_init(seed=0, config=cfg, dtype=_DTYPES[dtype_str],
                                        device=device)
    return engine, RealtimeProcessor(ByteFallbackTokenizer(), channels=cfg.rvq), codec
