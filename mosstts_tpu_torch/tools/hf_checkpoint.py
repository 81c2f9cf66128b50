"""Write a checkpoint directory in the reference's HF layout from a port
model: ``config.json`` and safetensors shards under the reference's tensor
names (``utils/checkpoints.py``'s tables), with
``model.safetensors.index.json`` when there is more than one shard.

No released checkpoint is in the repository, so the tests and
``chip_smoke.py`` prove the loaders on directories this writes from random
weights. Usage from Python::

    from mosstts_tpu_torch.tools.hf_checkpoint import write_hf_checkpoint
    from mosstts_tpu_torch.utils.checkpoints import local_table
    write_hf_checkpoint("out/dir", params, cfg, local_table(cfg), shard_bytes=1 << 30)
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import torch

from ..utils.hf_loader import Entry, save_safetensors, state_dict_from_params


def write_hf_checkpoint(path, params, config, table: List[Entry], *,
                        shard_bytes: Optional[int] = None) -> dict:
    """Write ``params`` (a parameter module) under ``table``'s reference
    names into ``path``: tensors in their own dtype, cut into shards of
    at most ``shard_bytes`` (one shard when None), the index file naming
    each tensor's shard. Returns
    ``{"tensors": n, "bytes": b, "shards": k}``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.json", "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)
    shards, cur, size, total = [], {}, 0, 0
    for name, t in state_dict_from_params(params, table):
        nbytes = t.numel() * t.element_size()
        if cur and shard_bytes is not None and size + nbytes > shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[name] = t
        size += nbytes
        total += nbytes
    shards.append(cur)
    if len(shards) == 1:
        save_safetensors(shards[0], path / "model.safetensors")
    else:
        weight_map = {}
        for k, shard in enumerate(shards):
            fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
            save_safetensors(shard, path / fname)
            weight_map.update({name: fname for name in shard})
        with open(path / "model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f,
                      indent=1)
    return {"tensors": sum(len(s) for s in shards), "bytes": total, "shards": len(shards)}


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def same_params(a, b) -> bool:
    """Every parameter of ``a`` equal to ``b``'s of the same name bit for
    bit (same names, shapes and dtypes; the values compared as integers of
    their width, so -0.0 differs from 0.0 and a NaN equals itself)."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if set(pa) != set(pb):
        return False
    for n, x in pa.items():
        y = pb[n].to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        bits = _BITS[x.element_size()]
        if not torch.equal(x.view(bits), y.view(bits)):
            return False
    return True
