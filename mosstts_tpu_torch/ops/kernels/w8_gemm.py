"""Int8-weight GEMMs: the CUDA kernels of ``csrc/w8_gemm.cu`` and their plain
PyTorch versions.

* ``w8a16_gemm``: ``(x @ q[n]) * scale[n]`` for each of ``count`` stacked
  int8 weights with a shared bf16 ``x``, float32 accumulation, output bf16
  (a ``dense`` layer) or f32 (the Delay audio heads). Ports the function of
  ``tools/tune_mm8.py::mm8``/``mm8_omajor`` and
  ``tools/probe_int4.py::mm8_pallas``; the serving path's int8 ``dense`` and
  heads (``mosstts_tpu/ops/basic.py:28-35``,
  ``mosstts_tpu/models/delay.py:56-61``) compute it.
* ``w8a8_gemm``: per-row int8 activations (``quant_rows``), an
  int32-accumulated product, ``f32(acc) * x_scale * w_scale``. Ports
  ``tools/tune_mm8.py::mm8_w8a8``.
* ``int4_gemm``: nibble-packed int4 weights (K = D/2 rows; low nibble W[d],
  high nibble W[d + D/2]) times x's two halves, f32 out, no scale. Ports
  ``tools/probe_int4.py::mm4_pallas``.

Each wrapper runs its plain version for CPU tensors and its kernel for CUDA
tensors, never falling back from one to the other; it raises on what the
kernel does not take and counts its launches (a split-K call is two device
launches, counted as one). The plain versions compute each product exactly
(float32, or float64 for the int8 x int8 sum, which float32 cannot hold
exactly) and apply the scales in the kernels' order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

BN, BK = 128, 64  # csrc/w8_gemm.cu: output columns per block, weight rows per k tile
MAX_SPLITS = 16
_OUT_F32 = {torch.bfloat16: 0, torch.float32: 1}

LAUNCHES_W8A16 = 0  # w8a16_gemm kernel launches since the count was last set to 0
LAUNCHES_W8A8 = 0  # w8a8_gemm kernel launches
LAUNCHES_INT4 = 0  # int4_gemm kernel launches


def _stack(q: torch.Tensor, scale: Optional[torch.Tensor]):
    """(K, N) or (count, K, N) weights and (N,)/(count, N) scales as stacks."""
    if q.ndim == 2:
        return q[None], None if scale is None else scale[None]
    return q, scale


def _unstack(y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, count, N) -> (M, N) for an unstacked weight."""
    return y[:, 0] if q.ndim == 2 else y


def w8a16_gemm_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: f32 product of x (..., K) and the int8 values (exact
    products, f32 sums), times the per-column scale, rounded once to
    ``out_dtype``."""
    qs, ss = _stack(q, scale)
    y = torch.matmul(x.reshape(-1, x.shape[-1]).float(), qs.float()) * ss[:, None, :]
    y = _unstack(y.transpose(0, 1), q)  # (M, count, N) or (M, N)
    return y.reshape(x.shape[:-1] + y.shape[1:]).to(out_dtype)


def quant_rows(x: torch.Tensor):
    """``tools/tune_mm8.py:92-96``: per-row absmax int8, scale
    max(absmax, 1e-8) / 127, round half to even, clip +-127. The divisions
    are true divisions, as the kernel's (a tensor divisor: on CUDA, PyTorch
    multiplies by the reciprocal of a Python-number divisor)."""
    xf = x.float()
    m = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    s = m / torch.full_like(m, 127.0)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def w8a8_gemm_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``quant_rows``, the int8 x int8 sum (float64, exact
    here), then ``f32(sum) * x_scale * w_scale``."""
    x8, xs = quant_rows(x)
    qs, ss = _stack(q, scale)
    acc = torch.matmul(x8.double(), qs.double()).float()  # (count, M, N)
    return _unstack((acc * xs * ss[:, None, :]).transpose(0, 1), q)


def unpack_int4(packed: torch.Tensor):
    """Packed int8 (..., D/2, N) -> the sign-extended low and high nibbles,
    int8 each: W[d] and W[d + D/2]."""
    p = packed.to(torch.int32)
    lo = p & 15
    hi = (p >> 4) & 15
    return (lo - 16 * (lo >> 3)).to(torch.int8), (hi - 16 * (hi >> 3)).to(torch.int8)


def int4_gemm_ref(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Plain version: x[:, :D/2] @ lo + x[:, D/2:] @ hi in f32."""
    lo, hi = unpack_int4(packed)
    h = packed.shape[-2]
    xf = x.float()
    y = torch.matmul(xf[:, :h], lo.float()) + torch.matmul(xf[:, h:2 * h], hi.float())
    return y


class GemmArgs(ctypes.Structure):
    """``mosstts::w8::Args`` of ``csrc/w8_gemm.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("x", "w", "w_scale", "x_scale", "out", "part")]
        + [(n, ctypes.c_int) for n in ("M", "K", "N", "count", "x_hi", "splits", "k_per_split",
                                       "out_f32")]
        + [(n, ctypes.c_longlong) for n in ("ldx", "w_sh", "ldo")]
    )


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M: int, K: int, n_blocks: int, sm_count: int):
    """(splits, K rows per split): split K until about two waves of blocks
    cover the SMs, at most ``MAX_SPLITS`` ways and two k tiles per split."""
    k_tiles = -(-K // BK)
    want = -(-2 * sm_count // n_blocks)
    splits = max(1, min(want, MAX_SPLITS, k_tiles // 2))
    per = -(-k_tiles // splits) * BK
    return -(-K // per), per


def _check_weight(name: str, x, q, scale, x_dtype) -> None:
    """Raise on what the kernel does not take. The common case is one
    expression: the serving path calls this 254 times per 8B decode step."""
    nd, qd, dev = x.dim(), q.dim(), x.get_device()
    if (x.dtype == x_dtype and q.dtype == torch.int8 and x.stride(-1) == 1
            and (nd == 2 and x.stride(0) % 8 == 0 or nd > 2 and x.is_contiguous())
            and x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0
            and qd in (2, 3) and q.is_contiguous() and q.get_device() == dev
            and (scale is None or (scale.dtype == torch.float32 and scale.is_contiguous()
                                   and scale.get_device() == dev and scale.dim() == qd - 1
                                   and scale.shape[-1] == q.shape[-1]
                                   and (qd == 2 or scale.shape[0] == q.shape[0])))):
        return
    if x.dtype != x_dtype or q.dtype != torch.int8:
        raise TypeError(f"{name}: x {x.dtype} must be {x_dtype}, q {q.dtype} int8")
    if nd < 2 or nd > 2 and not x.is_contiguous() or qd not in (2, 3) or not q.is_contiguous():
        raise ValueError(f"{name}: x (M, K) or contiguous (..., K) and contiguous q (K, N) or "
                         f"(count, K, N); got {tuple(x.shape)} and {tuple(q.shape)}")
    if scale is not None and (scale.dtype != torch.float32 or not scale.is_contiguous()
                              or tuple(scale.shape) != tuple(q.shape[:-2]) + (q.shape[-1],)):
        raise ValueError(f"{name}: scale must be contiguous f32 {tuple(q.shape[:-2]) + (q.shape[-1],)}")
    if x.stride(-1) != 1 or nd == 2 and x.stride(0) % 8 or x.data_ptr() % 16 or x.shape[-1] % 8:
        raise ValueError(f"{name}: x rows must be contiguous, 16-byte aligned, a multiple of 8 "
                         "elements long and apart")
    raise ValueError(f"{name}: tensors on different devices")


_PLANS: dict = {}  # launch shape -> (GemmArgs bytes with its shape fields, out shape, split-K size)
_SCRATCH: dict = {}  # (device index, stream) -> split-K scratch buffers, kept for the process


def _plan(x_shape: torch.Size, K: int, N: int, count: int, stacked: bool, x_hi: int, ldx: int,
          w_sh: int, out_dtype, index: int):
    """The split, the argument fields and the output shape of one launch
    shape, worked out once. x (..., K) gives M = the product of its leading
    dimensions rows."""
    key = (x_shape, K, N, count, stacked, x_hi, ldx, w_sh, out_dtype, index)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) > 4096:  # prompt lengths vary; keep the cache small
            _PLANS.clear()
        M = x_shape.numel() // x_shape[-1]
        n_blocks = count * -(-N // BN) * -(-M // (16 if M <= 16 else 64))
        splits, per = split_k(M, K, n_blocks, _sm_count(index))
        a = GemmArgs(M=M, K=K, N=N, count=count, x_hi=x_hi, splits=splits, k_per_split=per,
                     out_f32=_OUT_F32[out_dtype], ldx=ldx, w_sh=w_sh, ldo=count * N)
        plan = _PLANS[key] = (bytes(a), x_shape[:-1] + ((count, N) if stacked else (N,)),
                              splits * M * count * N if splits > 1 else 0)
    return plan


def _scratch(index: int, stream: int, n: int) -> int:
    """Address of a split-K scratch of at least ``n`` floats (or int32s) for
    launches on ``stream``. They run in order, so one buffer serves them
    all; a larger need adds a buffer and keeps the old one, which a CUDA
    graph captured earlier may still read."""
    bufs = _SCRATCH.setdefault((index, stream), [])
    if not bufs or bufs[-1].numel() < n:
        size = max(n, 2 * bufs[-1].numel()) if bufs else n
        bufs.append(torch.empty(size, dtype=torch.float32, device=torch.device("cuda", index)))
    return bufs[-1].data_ptr()


def _launch(entry: str, x, q, scale, out_dtype, *, K: int, x_hi: int = 0, x_scale=None,
            x_ptr=None, extra: tuple = ()) -> torch.Tensor:
    """Allocate the output, fill ``GemmArgs`` from the shape's cached plan
    and launch the C entry point ``entry`` on the current stream. Kept lean:
    the serving path calls it 254 times per 8B decode step."""
    index = x.device.index
    stacked = q.ndim == 3
    N = q.shape[-1]
    args, out_shape, n_part = _plan(x.shape, K, N, q.shape[0] if stacked else 1, stacked,
                                    x_hi, K if x_ptr is not None else
                                    x.stride(0) if x.dim() == 2 else x.shape[-1],
                                    q.shape[-2] * N, out_dtype, index)
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    a = GemmArgs.from_buffer_copy(args)
    a.x = x_ptr if x_ptr is not None else x.data_ptr()
    a.w = q.data_ptr()
    a.w_scale = scale.data_ptr() if scale is not None else None
    a.x_scale = x_scale.data_ptr() if x_scale is not None else None
    a.out = out.data_ptr()
    a.part = _scratch(index, stream, n_part) if n_part else None
    rc = _entry(entry, len(extra))(ctypes.byref(a), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def w8a16_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K), or contiguous (..., K), bf16; q (K, N) or (count, K, N)
    int8, contiguous (a layer or head of a stack is read in place); scale
    (N,)/(count, N) f32. Returns (..., N) or (..., count, N) in
    ``out_dtype`` (bf16 or f32)."""
    if not _on_cuda("w8a16_gemm", x):
        return w8a16_gemm_ref(x, q, scale, out_dtype)
    _check_weight("w8a16_gemm", x, q, scale, torch.bfloat16)
    if out_dtype not in _OUT_F32 or x.shape[-1] != q.shape[-2]:
        raise ValueError(f"w8a16_gemm: out_dtype {out_dtype}, x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}")
    out = _launch("mosstts_w8a16_gemm", x, q, scale, out_dtype, K=x.shape[-1])
    global LAUNCHES_W8A16
    LAUNCHES_W8A16 += 1
    return out


def w8a8_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16, quantized per row inside; q and scale as for
    ``w8a16_gemm``; K a multiple of 16. Returns f32 (M, N)/(M, count, N)."""
    if not _on_cuda("w8a8_gemm", x):
        return w8a8_gemm_ref(x, q, scale)
    _check_weight("w8a8_gemm", x, q, scale, torch.bfloat16)
    M, K = x.shape[0], x.shape[-1]
    if x.dim() != 2 or K % 16 or K != q.shape[-2]:
        raise ValueError(f"w8a8_gemm: K {K} must match q {tuple(q.shape)} and be a multiple of 16")
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = _launch("mosstts_w8a8_gemm", x, q, scale, torch.float32, K=K, x_scale=xs,
                  x_ptr=x8.data_ptr(), extra=(x.data_ptr(), x.stride(0)))
    global LAUNCHES_W8A8
    LAUNCHES_W8A8 += 1
    return out


def int4_gemm(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """x (M, D) bf16; packed (D/2, N) or (count, D/2, N) int8. Returns f32
    (M, N)/(M, count, N)."""
    if not _on_cuda("int4_gemm", x):
        return int4_gemm_ref(x, packed)
    _check_weight("int4_gemm", x, packed, None, torch.bfloat16)
    h = packed.shape[-2]
    if x.dim() != 2 or x.shape[1] != 2 * h or h % 8:
        raise ValueError(f"int4_gemm: x {tuple(x.shape)} must be (M, 2 * {h}), "
                         f"{h} a multiple of 8")
    out = _launch("mosstts_int4_gemm", x, packed, None, torch.float32, K=h, x_hi=h)
    global LAUNCHES_INT4
    LAUNCHES_INT4 += 1
    return out


@functools.cache
def _entry(name: str, n_extra: int = 0):
    """The C entry point ``name``: (args*, [x pointer, x row stride,] stream)."""
    from . import _build

    extra = [ctypes.c_void_p, ctypes.c_longlong][:n_extra]
    return _build.kernel(name, [ctypes.POINTER(GemmArgs)] + extra + [ctypes.c_void_p])
