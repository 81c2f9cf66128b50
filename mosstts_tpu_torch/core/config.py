"""The port's configurations: its own copy of the parts of
``mosstts_tpu/core/config.py`` it runs (the Qwen3 backbone, the Delay model,
the Local model, the Realtime model, the codec, and the ``qwen3_1p7b``/``qwen3_8b``/
``delay_8b``/``codec_1p6b``/``tiny_qwen3`` presets). Plain frozen dataclasses that ingest the reference's
``config.json`` via ``from_hf_dict``; the port imports nothing of the JAX
package, so it keeps this copy. ``LocalConfig`` is the MossTTSLocal
model's (the Delay fields plus the depth transformer's dimensions).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class Qwen3Config:
    """Decoder backbone hyperparameters (Qwen3-family layout).

    Matches the subset of HF ``Qwen3Config`` the reference models rely on.
    """

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 40960
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    pad_token_id: int = 151643

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "Qwen3Config":
        d = dict(d)
        if "head_dim" not in d or d.get("head_dim") is None:
            d["head_dim"] = d["hidden_size"] // d["num_attention_heads"]
        return cls(**_filter_kwargs(cls, d))

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


# ---------------------------------------------------------------------------
# Delay model (MossTTSDelay): one backbone, 1+n_vq channels in delay pattern.
# Special-token defaults follow moss_tts_delay/configuration_moss_tts.py:62-104.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DelayConfig:
    language_config: Qwen3Config = field(default_factory=Qwen3Config)
    n_vq: int = 32
    audio_vocab_size: int = 1024
    audio_pad_code: int = 1024
    pad_token_id: int = 151643
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    audio_start_token_id: int = 151652
    audio_end_token_id: int = 151653
    audio_user_slot_token_id: int = 151654
    audio_assistant_gen_slot_token_id: int = 151656
    audio_assistant_delay_slot_token_id: int = 151662
    sampling_rate: int = 24000
    initializer_range: float = 0.02

    @property
    def channels(self) -> int:
        return 1 + self.n_vq

    @property
    def audio_emb_vocab(self) -> int:
        # +1 extra slot for the pad code (reference: audio_vocab_size + 1,
        # moss_tts_delay/modeling_moss_tts.py:179,190)
        return self.audio_vocab_size + 1

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "DelayConfig":
        d = dict(d)
        lc = d.pop("language_config", None) or {}
        if not isinstance(lc, dict):
            lc = dataclasses.asdict(lc)
        return cls(language_config=Qwen3Config.from_hf_dict(lc), **_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str | Path) -> "DelayConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))


# ---------------------------------------------------------------------------
# Local model (MossTTSLocal): Delay config + depth-transformer dims
# (moss_tts_local/configuration_moss_tts.py:78-112).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LocalConfig:
    language_config: Qwen3Config = field(default_factory=Qwen3Config)
    n_vq: int = 32
    audio_vocab_size: int = 1024
    audio_pad_code: int = 1024
    pad_token_id: int = 151643
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    audio_start_token_id: int = 151652
    audio_end_token_id: int = 151653
    audio_user_slot_token_id: int = 151654
    audio_assistant_gen_slot_token_id: int = 151656
    audio_assistant_delay_slot_token_id: int = 151662
    sampling_rate: int = 24000
    initializer_range: float = 0.02
    # Depth ("local") transformer dims
    additional_mlp_ffn_hidden_size: int = 2048
    local_ffn_hidden_size: int = 8960
    local_hidden_size: int = 1536
    local_num_layers: int = 4

    @property
    def channels(self) -> int:
        return 1 + self.n_vq

    @property
    def audio_emb_vocab(self) -> int:
        return self.audio_vocab_size + 1

    @property
    def local_transformer_config(self) -> Qwen3Config:
        """The depth transformer reuses the backbone layer layout with
        mutated dims (reference moss_tts_local/modeling_moss_tts.py:581-586)."""
        return dataclasses.replace(
            self.language_config,
            num_hidden_layers=self.local_num_layers,
            hidden_size=self.local_hidden_size,
            intermediate_size=self.local_ffn_hidden_size,
        )

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "LocalConfig":
        d = dict(d)
        lc = d.pop("language_config", None) or {}
        if not isinstance(lc, dict):
            lc = dataclasses.asdict(lc)
        return cls(language_config=Qwen3Config.from_hf_dict(lc), **_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str | Path) -> "LocalConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))


# ---------------------------------------------------------------------------
# Realtime model: Qwen3 backbone + RoPE'd 4-layer local transformer
# (configuration_mossttsrealtime.py:35-113).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RealtimeLocalConfig:
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 4
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 33
    attention_bias: bool = False
    audio_pad_token: int = 1024
    audio_vocab_size: int = 1027
    rvq: int = 16
    initializer_range: float = 0.02

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "RealtimeLocalConfig":
        return cls(**_filter_kwargs(cls, dict(d)))

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


@dataclass(frozen=True)
class RealtimeConfig:
    language_config: Qwen3Config = field(default_factory=Qwen3Config)
    local_config: RealtimeLocalConfig = field(default_factory=RealtimeLocalConfig)
    rvq: int = 16
    audio_pad_token: int = 1024
    audio_vocab_size: int = 1027  # 1024 codes + pad(1024)/bos(1025)/eos(1026)
    reference_audio_pad: int = 151654
    text_pad: int = 151655
    initializer_range: float = 0.02
    audio_bos_token: int = 1025
    audio_eos_token: int = 1026

    @property
    def channels(self) -> int:
        return 1 + self.rvq

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "RealtimeConfig":
        d = dict(d)
        lc = d.pop("language_config", None) or {}
        loc = d.pop("local_config", None) or {}
        return cls(
            language_config=Qwen3Config.from_hf_dict(lc),
            local_config=RealtimeLocalConfig.from_hf_dict(loc),
            **_filter_kwargs(cls, d),
        )

    @classmethod
    def from_json(cls, path: str | Path) -> "RealtimeConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))


# ---------------------------------------------------------------------------
# Audio codec ("Cat" MOSS-Audio-Tokenizer equivalent). The reference ships no
# codec source (empty moss_audio_tokenizer/); this config describes our
# TPU-native reimplementation of the documented contract:
# 24 kHz -> 12.5 Hz frames, 32-layer RVQ x 1024 codes, causal transformer
# encoder/decoder, streaming decode (README.md:378-389, SURVEY.md S2.9).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CodecConfig:
    sampling_rate: int = 24000
    frame_rate: float = 12.5
    n_q: int = 32
    codebook_size: int = 1024
    codebook_dim: int = 256
    hidden_size: int = 512
    intermediate_size: int = 1536
    num_encoder_layers: int = 8
    num_decoder_layers: int = 8
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    causal_context: int = 128  # frames of causal attention context
    # decoder overlap-add synthesis: each frame predicts hop + hop//overlap_div
    # samples; adjacent frames crossfade over the extra tail
    overlap_div: int = 4

    @property
    def hop(self) -> int:
        hop = int(round(self.sampling_rate / self.frame_rate))
        return hop

    @property
    def overlap(self) -> int:
        return self.hop // self.overlap_div

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "CodecConfig":
        return cls(**_filter_kwargs(cls, dict(d)))


def codec_1p6b(**over) -> CodecConfig:
    """Parity-scale codec preset (~1.5B transformer params): the reference
    Cat / MOSS-Audio-Tokenizer is a 1.6B-param codec with SOTA reconstruction
    at 0.125-4 kbps (README.md:378-408; it ships weights but no source).
    22+22 causal transformer layers at hidden 1536 / ffn 6144."""
    base = dict(
        hidden_size=1536, intermediate_size=6144,
        num_encoder_layers=22, num_decoder_layers=22,
        num_attention_heads=12, num_key_value_heads=4, head_dim=128,
        codebook_dim=256,
    )
    base.update(over)
    return CodecConfig(**base)


def qwen3_1p7b(**over) -> Qwen3Config:
    """Qwen3-1.7B-class backbone (the reference Local/Realtime scale)."""
    base = dict(
        vocab_size=151936, hidden_size=2048, intermediate_size=6144,
        num_hidden_layers=28, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128,
    )
    base.update(over)
    return Qwen3Config(**base)


def qwen3_8b(**over) -> Qwen3Config:
    """Qwen3-8B-class backbone — the reference Delay flagship scale
    (README.md:91-101, docs/moss_tts_model_card.md: MossTTSDelay 8B)."""
    base = dict(
        vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_hidden_layers=36, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128,
    )
    base.update(over)
    return Qwen3Config(**base)


def delay_8b(**over) -> DelayConfig:
    """Flagship MOSS-TTS Delay config (8B backbone, 32 RVQ channels)."""
    return DelayConfig(language_config=qwen3_8b(), n_vq=32, **over)


def tiny_qwen3(**over) -> Qwen3Config:
    """A small backbone config for tests and CPU smoke runs."""
    base = dict(
        vocab_size=152064,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        max_position_embeddings=512,
    )
    base.update(over)
    return Qwen3Config(**base)
