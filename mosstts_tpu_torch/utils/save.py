"""Framework-native checkpoint save and load: a model's parameter module
<-> ``model.safetensors`` + ``config.json``, for all model families.

Ports ``mosstts_tpu/utils/save.py`` (``flatten_pytree``, ``save_model``,
``load_model``) in the JAX package's own format, so a directory either
package writes loads in the other: the tensor names are the parameter tree's
dotted names (which the port's modules share), a bfloat16 tensor is stored
as its uint16 bits under ``<name>::bf16``, and ``config.json`` is the
config dataclass with ``model_type`` (``moss_tts_delay``,
``moss_tts_local`` or ``moss_tts_realtime``). The port writes with its own
writer and reads with its own reader (``utils/hf_loader.py``).
``utils/checkpoints.py`` reads the reference's HF layout instead.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

import torch
from torch import nn

from ..core.config import DelayConfig, LocalConfig, RealtimeConfig
from ..models.delay import DelayParams
from ..models.local import LocalParams
from ..models.realtime import RealtimeParams
from .convert import load_tree_
from .hf_loader import SafetensorsFile, save_safetensors

_BF16 = "::bf16"
FAMILIES = {"moss_tts_delay": (DelayConfig, DelayParams),
            "moss_tts_local": (LocalConfig, LocalParams),
            "moss_tts_realtime": (RealtimeConfig, RealtimeParams)}


def flatten_params(params: nn.Module) -> Dict[str, torch.Tensor]:
    """Ports ``flatten_pytree``: name -> tensor, a bfloat16 one as its
    uint16 bits under ``<name>::bf16``."""
    out = {}
    for name, p in params.named_parameters():
        t = p.detach()
        if t.dtype == torch.bfloat16:
            out[name + _BF16] = t.contiguous().view(torch.uint16)
        else:
            out[name] = t
    return out


def save_model(path, params: nn.Module, config, model_type: str) -> None:
    """Ports ``save_model``: write ``<path>/model.safetensors`` and
    ``config.json`` (with ``model_type``)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.asdict(config)
    cfg["model_type"] = model_type
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f, indent=2)
    save_safetensors(flatten_params(params), path / "model.safetensors")


@torch.no_grad()
def load_model(path, dtype=None, device="cuda"):
    """Ports ``load_model``: (the family's parameter module on ``device``,
    its config), the family chosen by ``model_type``. The module takes
    ``dtype``, or by default the dtype the file stores its weights in."""
    path = Path(path)
    if not (path / "config.json").is_file():
        raise FileNotFoundError(f"no saved model (config.json) at {str(path)!r}")
    with open(path / "config.json") as f:
        cfg_dict = json.load(f)
    cfg_cls, params_cls = FAMILIES[cfg_dict.pop("model_type", "moss_tts_delay")]
    config = cfg_cls.from_hf_dict(cfg_dict)
    flat = {}
    for key, t in SafetensorsFile(path / "model.safetensors").items():
        if key.endswith(_BF16):
            key, t = key[:-len(_BF16)], t.view(torch.bfloat16)
        flat[key] = t
    if dtype is None:
        dtype = next(t.dtype for t in flat.values() if t.is_floating_point())
    return load_tree_(params_cls(config, dtype=dtype, device=device), flat), config
