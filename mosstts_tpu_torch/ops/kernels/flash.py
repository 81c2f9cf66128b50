"""Prefill flash attention: the CUDA kernel ``csrc/flash_attn.cu`` and its
plain PyTorch version.

Ports ``mosstts_tpu/ops/pallas/flash.py::flash_attention``: causal GQA with
a left-pad mask ``kv_valid``, the causal mask from the absolute position
``q_start`` of query row 0 (key slot index == position), and an optional
sliding window. The TPU tile sizes (``block_t``/``block_s``) are not part of
the port.

``flash_attention`` runs ``flash_attention_ref`` for CPU tensors and the
kernel for CUDA tensors; it never falls back from one to the other. bf16
inputs take the tensor-core body of the kernel (K/V copied 16 bytes at a
time, so their rows, and q's, must start at 16-byte boundaries), f32 inputs
its CUDA-core body.

Rows whose query sees no unmasked key (left-pad positions) are garbage by
design in both versions; the kernel averages the keys it visited, the plain
version all S keys. Nothing reads those rows.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from ..attention import gqa_attention, gqa_attention_kvmajor

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

LAUNCHES = 0  # kernel launches since the count was last set to 0


def supports(head_dim: int, num_heads: int, num_kv_heads: int) -> bool:
    """Shapes the kernel takes (the JAX ``_flash_ok`` shape conditions)."""
    return head_dim in SUPPORTED_HEAD_DIMS and num_heads % num_kv_heads == 0


def flash_attention_ref(q, k, v, kv_valid, q_start, *, scale: float,
                        window: Optional[int] = None, kv_major: bool = False):
    """Plain version: ``gqa_attention`` with query positions
    ``q_start + arange(T)`` and key positions ``arange(S)``."""
    B, T = q.shape[:2]
    S = k.shape[2] if kv_major else k.shape[1]
    dev = q.device
    q_pos = (q_start + torch.arange(T, dtype=torch.int32, device=dev))[None].expand(B, T)
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    fn = gqa_attention_kvmajor if kv_major else gqa_attention
    return fn(q, k, v, q_positions=q_pos, kv_positions=kv_pos, kv_valid=kv_valid,
              scale=scale, window=window)


def flash_attention(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd); or (B, KV, S, hd) when kv_major=True
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B, S) bool
    q_start: Union[int, torch.Tensor],  # absolute position of q[:, 0]
    *,
    scale: float,
    window: Optional[int] = None,
    kv_major: bool = False,
) -> torch.Tensor:
    """Returns (B, T, H, hd) in q's dtype. ``kv_major=True`` reads k/v in the
    KV-cache layout, e.g. the strided view ``cache.k[li]``, without a copy.
    ``q_start`` may be an int or a one-element int32 tensor on q's device
    (read by the kernel, so no host sync)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_valid, q_start, scale=scale,
                                   window=window, kv_major=kv_major)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, T, H, hd = q.shape
    if kv_major:
        KV, S = k.shape[1], k.shape[2]
        (k_sb, k_sh, k_ss, _), (v_sb, v_sh, v_ss, _) = k.stride(), v.stride()
    else:
        S, KV = k.shape[1], k.shape[2]
        (k_sb, k_ss, k_sh, _), (v_sb, v_ss, v_sh, _) = k.stride(), v.stride()
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes bf16 or f32, the same for q, k and v")
    if not supports(hd, H, KV):
        raise ValueError(f"flash_attention: head_dim {hd} (H={H}, KV={KV}) not supported")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if kv_valid.dtype != torch.bool or kv_valid.shape != (B, S):
        raise ValueError(f"flash_attention: kv_valid must be bool (B, S)=({B}, {S})")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1 or kv_valid.stride(1) != 1:
        raise ValueError("flash_attention: the head dim of q/k/v and the slot dim of "
                         "kv_valid must be contiguous")
    for t in (k, v, kv_valid):
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q/k/v rows must start at 16-byte boundaries "
                         "(base pointers and strides in multiples of 8 elements)")
    if isinstance(q_start, torch.Tensor):
        if (q_start.dtype != torch.int32 or q_start.numel() != 1
                or q_start.device != q.device):
            raise ValueError("flash_attention: a tensor q_start must be one int32 on q's device")
        q_start_ptr, q_start_val = q_start.data_ptr(), 0
    else:
        q_start_ptr, q_start_val = None, int(q_start)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")

    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
        q_start_ptr, q_start_val, B, T, H, KV, S, hd,
        q.stride(0), q.stride(1), q.stride(2), k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        kv_valid.stride(0), out.stride(0), out.stride(1), out.stride(2),
        float(scale), int(window or 0), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


@functools.cache
def _entry():
    import ctypes

    from . import _build

    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return _build.kernel(
        "mosstts_flash_attention",
        [p, p, p, p, p, p, i, i, i, i, i, i, i]
        + [i64] * 13 + [ctypes.c_float, i, i, p],
    )
