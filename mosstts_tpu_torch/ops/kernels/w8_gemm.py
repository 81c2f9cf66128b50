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

* ``w8f32_gemm``: W8A16's function with float32 activations and f32 out
  (the int8 codec's encoder: ``mosstts_tpu/ops/basic.py:28-30`` with f32
  activations), mode F32X3: x split into three bf16 terms (``split3_bf16``)
  whose products with the int8 values, exact, go to one f32 accumulator on
  the tensor cores, so x is not rounded.

All four are modes of one kernel (``csrc/w8_gemm.cu`` ``ring_kernel``):
one device kernel per product, whose tile variant and split of K over a
thread-block cluster (the blocks sum their partials inside the launch)
``gemm_plan`` picks; W8A8 first quantizes x's rows in a launch of its own,
and F32X3 splits x into its terms in one.
Each wrapper runs its plain version for CPU tensors and its kernel for CUDA
tensors, never falling back from one to the other; it raises on what the
kernel does not take and counts its calls (a call of two device kernels
counts one). The plain versions compute each
product exactly (float32, or float64 for the int8 x int8 sum, which float32
cannot hold exactly) and apply the scales in the kernels' order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

_OUT_F32 = {torch.bfloat16: 0, torch.float32: 1}

W8A16, W8A8, INT4, F32X3 = 0, 1, 2, 3  # csrc/w8_gemm.cu Mode
# csrc/w8_gemm.cu ring::V0-V5, Q0-Q3, I0-I3, F0-F2, each mode's
# instantiations of the kernel: (MT 16-row tiles, BN columns, its consumer
# warps across the row tiles (WM), the 32-column groups (WN) and the mma k
# steps of a stage (WK: k16 steps, k32 for W8A8), STAGES ring tiles, NP
# producer warps, MINB blocks an SM at least (its register budget))
A16_VARIANTS = ((1, 64, 1, 1, 8, 5, 2, 3), (1, 128, 1, 2, 4, 6, 2, 3), (2, 128, 1, 4, 2, 4, 2, 2),
                (4, 128, 1, 4, 2, 4, 2, 2), (8, 128, 2, 4, 1, 3, 2, 2), (6, 128, 2, 4, 1, 3, 2, 2))
A8_VARIANTS = ((1, 128, 1, 4, 2, 6, 2, 3), (2, 128, 1, 4, 2, 5, 2, 2), (4, 128, 2, 4, 1, 5, 2, 2),
               (8, 128, 2, 4, 1, 12, 2, 1))
I4_VARIANTS = ((1, 128, 1, 4, 2, 5, 2, 3), (2, 128, 1, 4, 2, 4, 2, 2), (4, 128, 1, 4, 2, 8, 2, 1),
               (8, 128, 2, 4, 1, 5, 2, 1))
F32_VARIANTS = ((1, 64, 1, 1, 8, 4, 2, 2), (2, 128, 1, 4, 2, 4, 4, 1), (8, 128, 2, 4, 1, 3, 2, 1))
VARIANTS = {W8A16: A16_VARIANTS, W8A8: A8_VARIANTS, INT4: I4_VARIANTS, F32X3: F32_VARIANTS}
STAGE_W = 8192  # weight bytes per ring tile: BK = STAGE_W // BN rows
MAX_CLUSTER = 8  # blocks per cluster (the split of K): the portable cluster size

LAUNCHES_W8A16 = 0  # w8a16_gemm kernel launches since the count was last set to 0
LAUNCHES_W8A16_BYTES = 0  # of those, launches on byte-loaded (not 16-byte aligned) weight rows
LAUNCHES_W8A8 = 0  # w8a8_gemm kernel launches
LAUNCHES_INT4 = 0  # int4_gemm kernel launches
LAUNCHES_W8F32 = 0  # w8f32_gemm kernel launches


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
        [(n, ctypes.c_void_p) for n in ("x", "w", "w_scale", "x_scale", "out")]
        + [(n, ctypes.c_int) for n in ("M", "K", "N", "count", "x_hi", "splits", "out_f32")]
        + [(n, ctypes.c_longlong) for n in ("ldx", "w_sh", "ldo", "ldw")]
        + [(n, ctypes.c_int) for n in ("variant", "vec")]
    )


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_weight(name: str, x, q, scale, x_dtype, pitched: bool = False) -> None:
    """Raise on what the kernel does not take. The common case is one
    expression: the serving path calls this 254 times per 8B decode step.
    With ``pitched`` (W8A16) q's rows may lie further apart than N (a
    stack kept at a 16-byte row pitch, ``ops/quant.py``); else q is
    contiguous."""
    nd, qd, dev = x.dim(), q.dim(), x.get_device()
    if (x.dtype == x_dtype and q.dtype == torch.int8 and x.stride(-1) == 1
            and (nd == 2 and x.stride(0) % 8 == 0 or nd > 2 and x.is_contiguous())
            and x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0
            and qd in (2, 3) and q.get_device() == dev
            and (q.is_contiguous() or pitched and q.stride(-1) == 1
                 and q.stride(-2) >= q.shape[-1])
            and (scale is None or (scale.dtype == torch.float32 and scale.is_contiguous()
                                   and scale.get_device() == dev and scale.dim() == qd - 1
                                   and scale.shape[-1] == q.shape[-1]
                                   and (qd == 2 or scale.shape[0] == q.shape[0])))):
        return
    if x.dtype != x_dtype or q.dtype != torch.int8:
        raise TypeError(f"{name}: x {x.dtype} must be {x_dtype}, q {q.dtype} int8")
    q_ok = q.is_contiguous() or pitched and q.stride(-1) == 1 and q.stride(-2) >= q.shape[-1]
    if nd < 2 or nd > 2 and not x.is_contiguous() or qd not in (2, 3) or not q_ok:
        raise ValueError(f"{name}: x (M, K) or contiguous (..., K) and q (K, N) or "
                         f"(count, K, N), " + ("its rows contiguous and at least N apart"
                                               if pitched else "contiguous")
                         + f"; got {tuple(x.shape)} and {tuple(q.shape)} {q.stride()}")
    if scale is not None and (scale.dtype != torch.float32 or not scale.is_contiguous()
                              or tuple(scale.shape) != tuple(q.shape[:-2]) + (q.shape[-1],)):
        raise ValueError(f"{name}: scale must be contiguous f32 {tuple(q.shape[:-2]) + (q.shape[-1],)}")
    if x.stride(-1) != 1 or nd == 2 and x.stride(0) % 8 or x.data_ptr() % 16 or x.shape[-1] % 8:
        raise ValueError(f"{name}: x rows must be contiguous, 16-byte aligned, a multiple of 8 "
                         "elements long and apart")
    raise ValueError(f"{name}: tensors on different devices")


def a16_columns(N: int, count: int, bn: int):
    """(tiles per weight, tail blocks) of a launch (``ring::
    column_blocks``): a remainder of 1-16 columns after N's full tiles is
    packed, bn / 16 weights' remainders to a tail block; a larger one is a
    narrow last tile."""
    rem = N % bn
    if rem and rem <= 16:
        return N // bn, -(-count // (bn // 16))
    return -(-N // bn), 0


class GemmPlan(NamedTuple):
    variant: int  # index into the mode's VARIANTS
    mt: int  # 16-row tiles of a block
    bn: int  # columns of a block
    bk: int  # weight rows per ring tile
    tiles: int  # column tiles per weight
    tail_blocks: int  # blocks of packed remainder columns
    row_tiles: int  # blocks along M
    splits: int  # blocks per cluster: split r takes k tiles [r * k_tiles / splits, ...)
    k_tiles: int  # ring tiles of K


def gemm_plan(M: int, K: int, N: int, count: int, sm_count: int, *, mode: int = W8A16,
              variant: Optional[int] = None, splits: Optional[int] = None) -> GemmPlan:
    """The launch of one mode and shape (K: weight rows, packed rows for
    INT4), from the sweeps of ``tools/w8a16_plans.py`` on an H100 (PERF.md
    §6). Each mode has its own instantiations (``VARIANTS[mode]``) over the
    same 8 KB weight stage; they differ in their x tiles (bf16, int8, INT4's
    two bf16 halves) and so in their ring depth and register budget.

    * K is split over s blocks of a cluster, s a power of two up to
      ``MAX_CLUSTER`` (clusters of 3, 5, 6 or 7 measured slower), each a
      whole number of ring tiles and none empty (their tile counts differ
      by at most one).
    * Decode (M <= 16, one 16-row tile): 64-column tiles (where the mode
      has them) unless 128-column ones already give every SM a block (the
      text head, the audio stack). A block streams its share of the weights
      at a rate bound by its warps, not by memory, so idle SMs cost more
      than the split's merge: s gives at least ~one block per SM, the least
      such s whose blocks fill their last round of SMs to 90% (192 blocks on
      132 SMs leave 60 SMs a second block, the rest idle), else the one
      that fills it best.
    * Prefill: the tensor cores bound it. M <= 128 is one row tile of 16 *
      MT rows, MT the least of the mode's (2, 4, 6, 8) that covers M (the
      weights streamed once); a longer M takes 64-, 96- or 128-row tiles.
      The tile and s minimise rounds x tile rows x K rows per block x (1 +
      c (s - 1)), a round being as many blocks as the card holds at once
      (MINB an SM by the register budget) and the last factor the merge's
      and x's cost per split: c = 0.1 for W8A16, 0.35 for W8A8 and INT4,
      whose 128- and 64-row tiles hold one block an SM and a deep ring (at
      the tools' shapes a split of 2 cost them 21-27%, of 4 49-68%); a tie
      goes to the larger tile.
    * F32X3 has a plan of its own (``f32x3_plan``).

    ``variant`` and ``splits`` (at most the k tiles) override the choice
    (``tools/w8a16_plans.py`` times the alternatives)."""
    if mode == F32X3:
        return f32x3_plan(M, K, N, sm_count, variant=variant, splits=splits)
    table = VARIANTS[mode]
    merge = 0.1 if mode == W8A16 else 0.35

    def shape(v):
        mt, bn = table[v][:2]
        bk = STAGE_W // bn
        tiles, tail = a16_columns(N, count, bn)
        return mt, bn, bk, tiles, tail, -(-M // (16 * mt)), -(-K // bk)

    sizes = (1, 2, 4, 8)
    if variant is None and M <= 16:
        decode = {table[v][1]: v for v in range(len(table)) if table[v][0] == 1}
        variant = decode.get(64) if 64 in decode and count * -(-N // 128) < sm_count else decode[128]
    if variant is None or splits is None and M > 16:
        if variant is not None:
            candidates = [variant]
        elif M <= 128:
            mt = min(t[0] for t in table if 1 < t[0] and 16 * t[0] >= M)
            candidates = [next(v for v, t in enumerate(table) if t[0] == mt)]
        else:
            candidates = [v for v, t in enumerate(table) if t[0] in (4, 6, 8)]
        best = None
        for v in candidates:
            mt, _, _, tiles, tail, rows, k_tiles = shape(v)
            blocks = (count * tiles + tail) * rows
            for s in (splits,) if splits is not None else sizes:
                if s > max(1, min(MAX_CLUSTER, k_tiles)):
                    continue
                rounds = -(-blocks * s // (table[v][7] * sm_count))
                cost = rounds * mt * -(-k_tiles // s) * (1 + merge * (s - 1))
                if best is None or cost < best[0] or cost == best[0] and mt > best[3]:
                    best = (cost, v, s, mt)
        variant, splits = best[1], best[2]
    mt, bn, bk, tiles, tail, row_tiles, k_tiles = shape(variant)
    if splits is None:  # decode
        blocks = count * tiles + tail
        want = 0.9 * sm_count
        fit = [s for s in sizes if s <= max(1, min(MAX_CLUSTER, k_tiles))]
        fit = [s for s in fit if blocks * s >= want] or fit[-1:]
        fill = [blocks * s / sm_count / -(-blocks * s // sm_count) for s in fit]
        splits = next((s for s, f in zip(fit, fill) if f >= 0.9), fit[fill.index(max(fill))])
    return GemmPlan(variant, mt, bn, bk, tiles, tail, row_tiles, min(splits, k_tiles), k_tiles)


def f32x3_plan(M: int, K: int, N: int, sm_count: int, *, variant: Optional[int] = None,
               splits: Optional[int] = None) -> GemmPlan:
    """F32X3's launch (``w8f32_gemm``, one weight), from the sweep of
    ``tools/w8a16_plans.py --mode f32x3`` over the int8 codec's encoder
    shapes at M = 1-200 on an H100 (PERF.md §6). M <= 16 takes the 16-row
    tile of 64 columns (F0), more rows the 32-row (F1) or the 128-row tile
    (F2). Of those, with K split over s blocks of a cluster (a power of
    two up to ``MAX_CLUSTER``, whole ring tiles, none empty), the fewest
    rounds of blocks win (a second wave cost 25-60%), then the least
    rounds x ring tiles per block x (1 + MT): the 32-row tile gives narrow
    N more blocks, the 128-row tile reads the weights fewer times (wide N
    at M = 100-200). ``variant`` and ``splits`` override the choice."""
    best = None
    for v in ([variant] if variant is not None else [0] if M <= 16 else [1, 2]):
        mt, bn = F32_VARIANTS[v][:2]
        tiles, tail = a16_columns(N, 1, bn)
        row_tiles, k_tiles = -(-M // (16 * mt)), -(-K // (STAGE_W // bn))
        for s in [splits] if splits is not None else (1, 2, 4, 8):
            if s > max(1, min(MAX_CLUSTER, k_tiles)):
                continue
            rounds = -(-(tiles + tail) * row_tiles * s // sm_count)
            cost = (rounds, rounds * -(-k_tiles // s) * (1 + mt))
            if best is None or cost < best[0]:
                best = (cost, GemmPlan(v, mt, bn, STAGE_W // bn, tiles, tail, row_tiles,
                                       min(s, k_tiles), k_tiles))
    return best[1]


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


_PLANS: dict = {}  # launch shape -> (GemmArgs bytes with its fields, out shape, tail bytes)


def _plan(mode: int, x_shape: torch.Size, K: int, N: int, count: int, stacked: bool, ldx: int,
          ldw: int, w_sh: int, x_hi: int, out_dtype, index: int):
    """``gemm_plan`` and the argument fields of one launch shape, worked
    out once, with the output shape and the bytes the last weight row's
    16-byte loads read past its N columns (rounding N up to 16)."""
    key = (mode, x_shape, K, N, count, stacked, ldx, ldw, w_sh, x_hi, out_dtype, index)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) > 4096:  # prompt lengths vary; keep the cache small
            _PLANS.clear()
        M = x_shape.numel() // x_shape[-1]
        p = gemm_plan(M, K, N, count, _sm_count(index), mode=mode)
        vec = int(ldw % 16 == 0 and w_sh % 16 == 0)
        a = GemmArgs(M=M, K=K, N=N, count=count, x_hi=x_hi, splits=p.splits,
                     out_f32=_OUT_F32[out_dtype], ldx=ldx, w_sh=w_sh, ldo=count * N, ldw=ldw,
                     variant=p.variant, vec=vec)
        plan = _PLANS[key] = (bytes(a), x_shape[:-1] + ((count, N) if stacked else (N,)),
                              vec and -N % 16)
    return plan


def _launch(mode: int, entry: str, x, q, scale, out_dtype, *, K: int, ldx: int, x_hi: int = 0,
            x_ptr=None, x_scale=None, extra: tuple = ()):
    """Fill ``GemmArgs`` from the shape's cached plan, allocate the output
    and launch the C entry point ``entry`` on the current stream; returns
    the output and whether the weights took 16-byte loads. Kept lean: the
    serving path calls it 254 times per 8B decode step."""
    index = x.device.index
    stacked = q.ndim == 3
    N = q.shape[-1]
    args, out_shape, over = _plan(mode, x.shape, K, N, q.shape[0] if stacked else 1, stacked, ldx,
                                  q.stride(-2), q.stride(0) if stacked else 0, x_hi, out_dtype,
                                  index)
    a = GemmArgs.from_buffer_copy(args)
    a.x = x.data_ptr() if x_ptr is None else x_ptr
    a.w = q.data_ptr()
    if a.vec and (a.w % 16 or over and (q.storage_offset() + over + sum(
            (n - 1) * st for n, st in zip(q.shape, q.stride())) >= q.untyped_storage().nbytes())):
        a.vec = 0  # a misaligned view, or the last row's padding lies past the storage
    a.w_scale = scale.data_ptr() if scale is not None else None
    a.x_scale = x_scale.data_ptr() if x_scale is not None else None
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    a.out = out.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(index)
    rc = _entry(entry, len(extra))(ctypes.byref(a), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out, a.vec


def w8a16_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K), or contiguous (..., K), bf16; q (K, N) or (count, K, N)
    int8 whose rows are contiguous and ``ldw = q.stride(-2) >= N`` bytes
    apart (a layer or head of a stack is read in place); scale (N,)/(count,
    N) f32. Returns (..., N) or (..., count, N) in ``out_dtype`` (bf16 or
    f32). Rows whose pitch, weight stride and address are multiples of 16
    bytes take 16-byte loads; others (an unpadded N % 16 != 0 stack) take
    the same kernel with byte loads, counted in ``LAUNCHES_W8A16_BYTES``."""
    if not _on_cuda("w8a16_gemm", x):
        return w8a16_gemm_ref(x, q, scale, out_dtype)
    _check_weight("w8a16_gemm", x, q, scale, torch.bfloat16, pitched=True)
    K = x.shape[-1]
    if out_dtype not in _OUT_F32 or K != q.shape[-2]:
        raise ValueError(f"w8a16_gemm: out_dtype {out_dtype}, x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}")
    out, vec = _launch(W8A16, "mosstts_w8a16_gemm", x, q, scale, out_dtype, K=K,
                       ldx=x.stride(0) if x.dim() == 2 else K)
    global LAUNCHES_W8A16, LAUNCHES_W8A16_BYTES
    LAUNCHES_W8A16 += 1
    LAUNCHES_W8A16_BYTES += not vec
    return out


def w8a8_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16, quantized per row inside; q (K, N) or (count, K, N)
    contiguous int8 and scale (N,)/(count, N) f32; K a multiple of 16.
    Returns f32 (M, N)/(M, count, N). Two device kernels: the row
    quantization, then the product."""
    if not _on_cuda("w8a8_gemm", x):
        return w8a8_gemm_ref(x, q, scale)
    _check_weight("w8a8_gemm", x, q, scale, torch.bfloat16)
    M, K = x.shape[0], x.shape[-1]
    if x.dim() != 2 or K % 16 or K != q.shape[-2]:
        raise ValueError(f"w8a8_gemm: K {K} must match q {tuple(q.shape)} and be a multiple of 16")
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    out, _ = _launch(W8A8, "mosstts_w8a8_gemm", x, q, scale, torch.float32, K=K, ldx=K,
                     x_ptr=x8.data_ptr(), x_scale=xs, extra=(x.data_ptr(), x.stride(0)))
    global LAUNCHES_W8A8
    LAUNCHES_W8A8 += 1
    return out


def int4_gemm(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """x (M, D) bf16; packed (D/2, N) or (count, D/2, N) contiguous int8.
    Returns f32 (M, N)/(M, count, N). One device kernel."""
    if not _on_cuda("int4_gemm", x):  # a stack's products as the kernel lays them out
        return _unstack(int4_gemm_ref(x, packed[None] if packed.ndim == 2 else packed)
                        .transpose(0, 1), packed)
    _check_weight("int4_gemm", x, packed, None, torch.bfloat16)
    h = packed.shape[-2]
    if x.dim() != 2 or x.shape[1] != 2 * h or h % 8:
        raise ValueError(f"int4_gemm: x {tuple(x.shape)} must be (M, 2 * {h}), "
                         f"{h} a multiple of 8")
    out, _ = _launch(INT4, "mosstts_int4_gemm", x, packed, None, torch.float32, K=h,
                     ldx=x.stride(0), x_hi=h)
    global LAUNCHES_INT4
    LAUNCHES_INT4 += 1
    return out


def split3_bf16(x: torch.Tensor):
    """Plain version of F32X3's split (``csrc/w8_gemm.cu`` ``ring::split3``,
    the prologue ``split3_kernel``): float32 x as three bf16 terms, each
    rounded to nearest, ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo =
    bf16(x - hi - mid)``. The differences are exact in float32, and ``hi +
    mid + lo == x`` wherever lo stays a normal bf16 (|x| >= 2**-110); below,
    the remainder is at most 2**-134, half of bf16's smallest subnormal
    step. A finite x that rounds past bf16's largest value keeps its
    truncation as hi; inf and NaN are hi alone (mid = lo = 0)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    trunc = (x.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    hi = torch.where(hi.isinf(), trunc, hi)  # inf stays inf: its truncation is inf
    finite = x.isfinite()
    r = torch.where(finite, x - hi.float(), torch.zeros_like(x))
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def w8f32_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) float32 with contiguous rows (a contiguous (..., K), or
    (M, K) rows ldx apart); q (K, N) int8 with contiguous rows ``ldw =
    q.stride(0) >= N`` bytes apart (a layer of a stack is read in place);
    scale (N,) f32. Returns (..., N) float32 ``(x @ q) * scale``: the
    F32X3 mode of the ring kernel, x's three bf16 terms (``split3_bf16``)
    times the int8 values in one f32 accumulator, the K split summed in rank
    order inside a cluster, so two calls give the same bits. Two device
    kernels: a prologue that writes x's terms, (M, 3 Kp) bf16, then the
    product."""
    if not _on_cuda("w8f32_gemm", x):
        return w8a16_gemm_ref(x, q, scale, torch.float32)
    if x.dtype != torch.float32 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w8f32_gemm: x {x.dtype} must be float32, q {q.dtype} int8, "
                        f"scale {scale.dtype} float32")
    K = x.shape[-1]
    rows_ok = x.dim() == 2 and x.stride(-1) == 1 or x.is_contiguous()
    if (q.dim() != 2 or q.shape[0] != K or q.stride(1) != 1 or q.stride(0) < q.shape[1]
            or tuple(scale.shape) != (q.shape[1],) or not scale.is_contiguous() or not rows_ok
            or x.get_device() != q.get_device() or q.get_device() != scale.get_device()):
        raise ValueError(f"w8f32_gemm: x {tuple(x.shape)} {x.stride()}, q {tuple(q.shape)} "
                         f"{q.stride()}, scale {tuple(scale.shape)} on one device")
    M, N = x.numel() // max(K, 1), q.shape[1]
    if x.numel() == 0:  # no rows, or K = 0: the empty sums
        return torch.zeros(x.shape[:-1] + (N,), dtype=torch.float32, device=x.device)
    kp = -(-K // 8) * 8
    terms = torch.empty((M, 3 * kp), dtype=torch.bfloat16, device=x.device)
    out, _ = _launch(F32X3, "mosstts_w8f32_gemm", x, q, scale, torch.float32, K=K, ldx=3 * kp,
                     x_hi=kp, x_ptr=terms.data_ptr(),
                     extra=(x.data_ptr(), x.stride(0) if x.dim() == 2 else K))
    global LAUNCHES_W8F32
    LAUNCHES_W8F32 += 1
    return out


@functools.cache
def _entry(name: str, n_extra: int = 0):
    """The C entry point ``name``: (args*, [x pointer, x row stride,] stream)."""
    from . import _build

    extra = [ctypes.c_void_p, ctypes.c_longlong][:n_extra]
    return _build.kernel(name, [ctypes.POINTER(GemmArgs)] + extra + [ctypes.c_void_p])
