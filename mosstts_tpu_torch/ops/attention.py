"""Grouped-query attention with explicit masks, in plain PyTorch.

Ports ``mosstts_tpu/ops/attention.py``: ``gqa_attention`` and
``gqa_attention_kvmajor``, the plain versions, and the test oracles, of the
two CUDA kernels in ``ops/kernels/``, and ``attention_nopos``. Math runs in float32 and the
result is cast back to the query dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _masked_softmax_out(qf, k, v, q_positions, kv_positions, kv_valid, window,
                        score_eq: str, out_eq: str, dtype):
    B, Tq, KV, G, hd = qf.shape
    scores = torch.einsum(score_eq, qf, k.float())  # (B, KV, G, Tq, Tk)
    rel = q_positions[:, :, None] - kv_positions[:, None, :]  # (B, Tq, Tk)
    mask = rel >= 0
    if window is not None:
        mask = mask & (rel < window)
    mask = mask & kv_valid[:, None, :]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(out_eq, probs, v.float())
    return out.reshape(B, Tq, KV * G, hd).to(dtype)


def gqa_attention(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd)
    *,
    q_positions: torch.Tensor,  # (B, Tq) int absolute positions
    kv_positions: torch.Tensor,  # (B, Tk) int absolute positions of key slots
    kv_valid: torch.Tensor,  # (B, Tk) bool: slot holds a real (non-pad) token
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.attention.gqa_attention``: causal GQA. A query
    at position p attends valid key slots at positions <= p (and > p - window
    with a sliding window). Returns (B, Tq, H, hd)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qf = (q.float() * scale).reshape(B, Tq, KV, H // KV, hd)
    return _masked_softmax_out(qf, k, v, q_positions, kv_positions, kv_valid, window,
                               "bqkgh,bskh->bkgqs", "bkgqs,bskh->bqkgh", q.dtype)


def gqa_attention_kvmajor(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, KV, Tk, hd): the KV-cache layout
    v: torch.Tensor,  # (B, KV, Tk, hd)
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.attention.gqa_attention_kvmajor``:
    ``gqa_attention`` over kv-head-major k/v, read without a transpose."""
    B, Tq, H, hd = q.shape
    KV = k.shape[1]
    qf = (q.float() * scale).reshape(B, Tq, KV, H // KV, hd)
    return _masked_softmax_out(qf, k, v, q_positions, kv_positions, kv_valid, window,
                               "bqkgh,bksh->bkgqs", "bkgqs,bksh->bqkgh", q.dtype)


def attention_nopos(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.attention.attention_nopos``: plain causal
    attention with no positional encoding and no padding, over a fixed-length
    block (the reference's MossTTSLocal depth transformer,
    moss_tts_local/modeling_moss_tts.py:126-176)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qf = (q.float() * scale).reshape(B, T, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    i = torch.arange(T, device=q.device)
    causal = i[:, None] >= i[None, :]
    scores = torch.where(causal[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)
