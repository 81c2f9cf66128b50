"""Checkpoint name-mapping tables: the reference's HF checkpoints -> the
port's parameter modules.

Ports ``mosstts_tpu/utils/checkpoints.py``: ``delay_params_from_state_dict``,
``local_params_from_state_dict``, ``realtime_params_from_state_dict`` and
``load_{delay,local,realtime}_checkpoint``. Each loader builds the model's
module on the target device in the target dtype and copies the
reference-format state dict (the released checkpoints' safetensors shards,
read lazily by ``utils.hf_loader.load_safetensors_dir``) into it tensor by
tensor, following the tables below (``*_table``), which are the
reference's module paths:

Delay (moss_tts_delay/modeling_moss_tts.py:164-194):
    language_model.<qwen3>                      -> backbone
    emb_ext.{i}.weight        (i in 0..n_vq-1)  -> audio_emb[i]
    lm_heads.0.weight^T                         -> text_head
    lm_heads.{i}.weight^T     (i in 1..n_vq)    -> audio_heads[i-1]

Local (moss_tts_local/modeling_moss_tts.py:495-611):
    model.embedding_list.0.weight               -> text_emb
    model.embedding_list.{i}.weight             -> audio_emb[i-1]
    model.language_model.<qwen3>                -> backbone
    local_transformer.<qwen3-no-embed>          -> local
    speech_embedding_to_local_mlp.{gate,up,down}_proj.weight^T -> mlp_in
    local_to_speech_embedding_mlps.{i}....^T    -> mlp_out_text / mlp_out_audio[i-1]
    layer_norm_before_lm_heads.{i}.weight       -> ln_text / ln_audio[i-1]
    lm_heads.{i}.weight^T                       -> text_head / audio_heads[i-1]

Realtime (mossttsrealtime/modeling_mossttsrealtime.py:80-99,
modeling_mossttsrealtime_local.py:270-393):
    embed_tokens.0.weight                       -> text_emb
    embed_tokens.{i}.weight                     -> audio_emb[i-1]
    language_model.<qwen3>                      -> backbone
    local_transformer.model.<qwen3-no-embed>    -> local
    local_transformer.model.embed_tokens.{i}.weight -> local_emb[i]  (rvq - 1 of them)
    local_transformer.local_lm_heads.{i}.weight^T   -> local_heads[i]

``<qwen3>`` is ``utils.hf_loader.qwen3_table``'s. A missing directory or
``config.json`` raises ``FileNotFoundError``.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Mapping

import torch

from ..core.config import DelayConfig, LocalConfig, RealtimeConfig
from ..models.delay import DelayParams
from ..models.local import LocalParams
from ..models.realtime import RealtimeParams, local_qwen_cfg
from .hf_loader import Entry, fill_from_state_dict_, load_safetensors_dir, qwen3_table


def delay_table(cfg: DelayConfig) -> List[Entry]:
    """The Delay model's names (module docstring)."""
    n = cfg.n_vq
    return qwen3_table(cfg.language_config, prefix="language_model.", dst="backbone.") + [
        Entry("audio_emb", "emb_ext.{i}.weight", n),
        Entry("text_head", "lm_heads.0.weight", transpose=True),
        Entry("audio_heads", "lm_heads.{i}.weight", n, True, start=1),
    ]


def _mlp_entries(dst: str, src: str, n=None, start: int = 0) -> List[Entry]:
    return [Entry(f"{dst}.{w}", f"{src}.{w}_proj.weight", n, True, start)
            for w in ("gate", "up", "down")]


def local_table(cfg: LocalConfig) -> List[Entry]:
    """The Local model's names (module docstring): index 0 of the
    ``local_to_speech`` adapters, norms and heads is the text channel, so
    ``{i} >= 1`` goes to audio channel ``i - 1``."""
    n = cfg.n_vq
    return (
        [Entry("text_emb", "model.embedding_list.0.weight"),
         Entry("audio_emb", "model.embedding_list.{i}.weight", n, start=1)]
        + qwen3_table(cfg.language_config, prefix="model.language_model.", dst="backbone.",
                      with_embed=False)
        + qwen3_table(cfg.local_transformer_config, prefix="local_transformer.", dst="local.",
                      with_embed=False)
        + _mlp_entries("mlp_in", "speech_embedding_to_local_mlp")
        + _mlp_entries("mlp_out_text", "local_to_speech_embedding_mlps.0")
        + _mlp_entries("mlp_out_audio", "local_to_speech_embedding_mlps.{i}", n, start=1)
        + [Entry("ln_text", "layer_norm_before_lm_heads.0.weight"),
           Entry("ln_audio", "layer_norm_before_lm_heads.{i}.weight", n, start=1),
           Entry("text_head", "lm_heads.0.weight", transpose=True),
           Entry("audio_heads", "lm_heads.{i}.weight", n, True, start=1)])


def realtime_table(cfg: RealtimeConfig) -> List[Entry]:
    """The Realtime model's names (module docstring)."""
    R = cfg.rvq
    return (
        [Entry("text_emb", "embed_tokens.0.weight"),
         Entry("audio_emb", "embed_tokens.{i}.weight", R, start=1)]
        + qwen3_table(cfg.language_config, prefix="language_model.", dst="backbone.",
                      with_embed=False)
        + qwen3_table(local_qwen_cfg(cfg.local_config), prefix="local_transformer.model.",
                      dst="local.", with_embed=False)
        + [Entry("local_emb", "local_transformer.model.embed_tokens.{i}.weight", R - 1),
           Entry("local_heads", "local_transformer.local_lm_heads.{i}.weight", R, True)])


def delay_params_from_state_dict(sd: Mapping, cfg: DelayConfig, dtype=torch.bfloat16,
                                 device="cuda") -> DelayParams:
    """Ports ``mosstts_tpu.utils.checkpoints.delay_params_from_state_dict``."""
    return fill_from_state_dict_(DelayParams(cfg, dtype=dtype, device=device), sd,
                                 delay_table(cfg))


def local_params_from_state_dict(sd: Mapping, cfg: LocalConfig, dtype=torch.bfloat16,
                                 device="cuda") -> LocalParams:
    """Ports ``mosstts_tpu.utils.checkpoints.local_params_from_state_dict``."""
    return fill_from_state_dict_(LocalParams(cfg, dtype=dtype, device=device), sd,
                                 local_table(cfg))


def realtime_params_from_state_dict(sd: Mapping, cfg: RealtimeConfig, dtype=torch.bfloat16,
                                    device="cuda") -> RealtimeParams:
    """Ports ``mosstts_tpu.utils.checkpoints.realtime_params_from_state_dict``."""
    return fill_from_state_dict_(RealtimeParams(cfg, dtype=dtype, device=device), sd,
                                 realtime_table(cfg))


def _config_path(path) -> Path:
    path = Path(path)
    if not (path / "config.json").is_file():
        raise FileNotFoundError(f"no checkpoint (config.json) at {str(path)!r}")
    return path / "config.json"


def load_delay_checkpoint(path, dtype=torch.bfloat16, device="cuda"):
    """Ports ``load_delay_checkpoint``: (``DelayParams`` on ``device``,
    ``DelayConfig``) from a checkpoint directory."""
    cfg = DelayConfig.from_json(_config_path(path))
    return delay_params_from_state_dict(load_safetensors_dir(path), cfg, dtype, device), cfg


def load_local_checkpoint(path, dtype=torch.bfloat16, device="cuda"):
    """Ports ``load_local_checkpoint``: (``LocalParams`` on ``device``,
    ``LocalConfig``) from a checkpoint directory."""
    cfg = LocalConfig.from_json(_config_path(path))
    return local_params_from_state_dict(load_safetensors_dir(path), cfg, dtype, device), cfg


def load_realtime_checkpoint(path, dtype=torch.bfloat16, device="cuda"):
    """Ports ``load_realtime_checkpoint``: (``RealtimeParams`` on ``device``,
    ``RealtimeConfig``) from a checkpoint directory."""
    cfg = RealtimeConfig.from_json(_config_path(path))
    return realtime_params_from_state_dict(load_safetensors_dir(path), cfg, dtype,
                                           device), cfg
