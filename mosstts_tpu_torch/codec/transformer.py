"""Chunked causal transformer runner with a sliding-window KV state.

Ports ``mosstts_tpu/codec/transformer.py``: ``StreamState``,
``init_stream_state`` and ``run_chunk``. Each chunk appends its K/V after
the carried window, attends with absolute ``kv_positions`` and a sliding
window of W, and keeps the most recent W slots, so chunked output equals
one-shot output.

As in JAX, the stream cursor (``next_pos``) and a chunk's count of real
frames (``valid_len``) are tensors on the state's device, and the kept
window is gathered at an index computed there (JAX's
``dynamic_slice_in_dim``): nothing reads a device value on the host, so one
captured CUDA graph of a chunk serves every ``valid_len`` and cursor.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..core.config import Qwen3Config
from ..nn.qwen3 import KVCache, Qwen3Params, qwen3_forward


class StreamState(NamedTuple):
    k: torch.Tensor  # (L, B, KV, W, hd): nn/qwen3.KVCache layout
    v: torch.Tensor
    positions: torch.Tensor  # (B, W) int32 absolute positions of slots
    valid: torch.Tensor  # (B, W) bool
    next_pos: torch.Tensor  # () int32


def init_stream_state(cfg: Qwen3Config, batch: int, window: int, *, dtype=torch.float32,
                      device=None) -> StreamState:
    """Ports ``mosstts_tpu.codec.transformer.init_stream_state``."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, window, cfg.head_dim)
    return StreamState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.zeros((batch, window), dtype=torch.int32, device=device),
        valid=torch.zeros((batch, window), dtype=torch.bool, device=device),
        next_pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def device_len(valid_len: Union[int, torch.Tensor], device) -> torch.Tensor:
    """``valid_len`` as a () int32 tensor on ``device``; a Python int is
    written by a fill (no host copy), a tensor is used as it is."""
    if isinstance(valid_len, torch.Tensor):
        return valid_len.to(device=device, dtype=torch.int32)
    return torch.full((), int(valid_len), dtype=torch.int32, device=device)


def run_chunk(params: Qwen3Params, cfg: Qwen3Config, state: StreamState,
              x: torch.Tensor,  # (B, c, D) chunk inputs (may be right-padded)
              valid_len: Union[int, torch.Tensor],  # real frames: () int32 tensor or int
              ) -> Tuple[torch.Tensor, StreamState]:
    """Ports ``mosstts_tpu.codec.transformer.run_chunk``."""
    B, c, _ = x.shape
    W = state.k.shape[3]
    dev = x.device
    valid_len = device_len(valid_len, dev)
    q_pos = state.next_pos + torch.arange(c, dtype=torch.int32, device=dev)
    q_positions = q_pos[None].expand(B, c)
    chunk_valid = (torch.arange(c, dtype=torch.int32, device=dev) < valid_len)[None].expand(B, c)

    pad = torch.zeros(state.k.shape[:3] + (c, state.k.shape[4]), dtype=state.k.dtype,
                      device=dev)
    cache = KVCache(torch.cat([state.k, pad], dim=3), torch.cat([state.v, pad], dim=3))
    kv_positions = torch.cat([state.positions, q_positions], dim=1)
    kv_valid = torch.cat([state.valid, chunk_valid], dim=1)

    h, cache = qwen3_forward(
        params, cfg, x, positions=q_positions, kv_valid=kv_valid, cache=cache,
        cache_offset=W, kv_positions=kv_positions, attn_window=W,
    )
    # keep the most recent W slots: [valid_len, valid_len + W), the start
    # clamped to [0, c] as JAX's dynamic_slice_in_dim clamps it
    keep = valid_len.clamp(0, c) + torch.arange(W, device=dev)
    return h, StreamState(
        k=cache.k.index_select(3, keep), v=cache.v.index_select(3, keep),
        positions=kv_positions.index_select(1, keep), valid=kv_valid.index_select(1, keep),
        next_pos=state.next_pos + valid_len,
    )
