"""Core plain ops: RMSNorm, dense, the per-channel head product, SwiGLU, RoPE.

Ports ``mosstts_tpu/ops/basic.py``. Rounding happens at the same points as
in the JAX package: RMSNorm reduces in float32 and casts back; ``dense``
accumulates in float32 and rounds once to the input dtype (a same-dtype
``torch.matmul`` does exactly that, and so does the W8A16 kernel for an int8
weight); RoPE rotates in float32. PyTorch lets cuBLAS reduce bf16 split-K
partial sums in bf16 by default
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
on an NVIDIA H100 that changed no bit of any 8B product, decode or prefill
(``tools/bf16_dense.py``), so the package leaves the flag as it is, and
``tests/test_torch_graphs_cuda.py`` holds ``dense`` to the same bits either
way. Weights keep the JAX (in, out) layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import w8_gemm
from .quant import is_quantized


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.basic.rms_norm``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (weight.float() * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.basic.dense`` (no bias): ``x @ w`` with w
    laid out (in, out), float32 accumulation, output in x's dtype. ``w`` may
    be an int8 ``QuantWeight``/``QuantView`` (``ops/quant.py``):
    ``(x @ q) * scale`` in float32, rounded once, through the W8A16 kernel
    on CUDA tensors (bf16 activations, as the JAX package serves int8
    weights), its float32-activation mode for float32 ones (the int8
    codec's encoder; ``w8_gemm.w8f32_gemm``; other dtypes raise there) and
    their plain version on the CPU."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return w8_gemm.w8f32_gemm(x.contiguous(), w.q, w.scale)
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise TypeError(f"dense: int8 weights take bf16 or float32 activations on the card, "
                        f"got {x.dtype}")
    return w8_gemm.w8a16_gemm(x.contiguous(), w.q, w.scale, x.dtype)


def head_logits(h: torch.Tensor, heads, i: int) -> torch.Tensor:
    """(B, D) x head ``i`` of a stack (n, D, V) -> (B, V) float32 logits,
    the accumulator as it is (the per-channel heads of the Realtime and
    Local depth transformers). An int8 stack reads head ``i``'s slice only,
    through the W8A16 kernel (``(h @ q[i]) * scale[i]``) on the card; bf16
    heads take one product with a float32 output on the card; float32
    heads, and every head on the CPU, the product in float32."""
    w = heads[i]
    if is_quantized(heads):
        return w8_gemm.w8a16_gemm(h.contiguous(), w.q, w.scale, torch.float32)
    if h.device.type == "cuda" and w.dtype != torch.float32:
        return torch.bmm(h[None], w[None], out_dtype=torch.float32)[0]
    return torch.matmul(h.float(), w.float())


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.basic.swiglu``."""
    return dense(F.silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.basic.rope_inv_freq``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """Ports ``mosstts_tpu.ops.basic.rope_cos_sin``: positions (..., T) ->
    cos/sin (..., T, head_dim), NeoX halves (HF Qwen3 convention)."""
    inv = rope_inv_freq(head_dim, theta, positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.basic.rotate_half``."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.basic.apply_rope``: x (B, T, H, hd); cos/sin
    (B, T, hd) or (T, hd)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def put_drop_(buf: torch.Tensor, index: tuple, val: torch.Tensor, keep: torch.Tensor) -> None:
    """``buf[index] = val`` in place where ``keep`` and no write elsewhere,
    as JAX's ``.at[index].set(val, mode="drop")``. Every entry of ``index``
    is in range: a dropped one points at a stand-in element and writes back
    its own value (one gather, one select, one scatter, no host sync). A
    kept and a dropped entry must not share an element."""
    old = buf[index]
    keep = keep.reshape(keep.shape + (1,) * (old.ndim - keep.ndim))
    buf[index] = torch.where(keep, val.to(buf.dtype), old)
