"""Single-token decode attention over the layer-stacked linear KV cache: the
CUDA kernels of ``csrc/decode_attn.cu`` and their plain PyTorch versions.

Ports ``mosstts_tpu/ops/pallas/decode_attn.py``:

* ``decode_attention``: one query token per row against layer ``layer`` of
  the (L, B, KV, S, hd) bf16/f32 cache, over the first ``attend_len`` slots;
* ``decode_attention_q8``: the same over an int8 cache with one f32 scale
  per (layer, row, KV head, slot), K's folded into the score and V's into
  the probability (the plain version dequantizes to f32 first, as the JAX
  package's non-kernel path does, ``nn/qwen3.py:476-481``);
* ``decode_attention_q8t``: ``decode_attention_q8`` with the scales in bf16
  or f32. The JAX kernel reads them pre-tiled (``pack_kv_scales``,
  ``pack_valid``) to get around a Mosaic lane-concat limit; the port keeps
  the (L, B, KV, S) scale layout, so it has neither. Nothing on the serving
  path calls it, as in the JAX package.

Causality rides ``kv_valid`` alone (a slot is valid iff it holds a token at
a position <= the current one; the Delay state machine keeps that
invariant), so there is no position arithmetic. The TPU tiling (``block_s``,
attend_len a multiple of it) is not part of the port: ``attend_len`` may be
any value in [1, S].

Each wrapper runs its plain version for CPU tensors and its kernel for CUDA
tensors; it never falls back from one to the other, and it raises on a
shape the kernel does not take. A kernel call is one launch: the blocks of
each (row, KV head) form a thread-block cluster that merges its split-KV
partial results in distributed shared memory, so the wrapper allocates
only the output. ``decode_plan`` picks the cluster size and the slots per
block. ``DecodeArgs``, ``decode_plan`` and ``launch`` are shared with
``paged_attn.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..attention import NEG_INF

SUPPORTED_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 4  # query heads per KV head the kernels take (csrc MAX_GROUP)
# csrc/decode_kernel.cuh: K bytes of one tile of its shared-memory ring,
# blocks per cluster (the portable maximum)
STAGE_BYTES, MAX_CLUSTER = 8192, 8
TARGET_BLOCKS = 2 * 132  # about two blocks per SM of an H100
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

LAUNCHES = 0  # decode_attention kernel launches since the count was last set to 0
LAUNCHES_Q8 = 0  # decode_attention_q8 kernel launches
LAUNCHES_Q8T = 0  # decode_attention_q8t kernel launches


def supports(head_dim: int, num_heads: int, num_kv_heads: int) -> bool:
    return (head_dim in SUPPORTED_HEAD_DIMS and num_heads % num_kv_heads == 0
            and num_heads // num_kv_heads <= MAX_GROUP)


def attend_rows(q, k, v, kv_valid, scale: float):
    """Softmax attention of one query token per row over (B, KV, A, hd)
    keys and values, masked by ``kv_valid`` (B, A); f32 inside, q's dtype
    out. The plain versions of all four decode kernels end here."""
    B, H, hd = q.shape
    KV = k.shape[1]
    qf = (q.float() * scale).reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgh,bksh->bkgs", qf, k.float())
    scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, kv_valid, layer: int, *,
                         scale: float, attend_len: int):
    """Plain version: softmax over the valid slots of the attended prefix."""
    return attend_rows(q, k_cache[layer, :, :, :attend_len], v_cache[layer, :, :, :attend_len],
                       kv_valid[:, :attend_len], scale)


def decode_attention_q8_ref(q, k_cache, k_scale, v_cache, v_scale, kv_valid, layer: int, *,
                            scale: float, attend_len: int):
    """Plain version of the int8 cache: dequantize the attended prefix to f32
    (value * its slot's scale), then ``decode_attention_ref``'s softmax."""
    a = attend_len
    k = k_cache[layer, :, :, :a].float() * k_scale[layer, :, :, :a, None]
    v = v_cache[layer, :, :, :a].float() * v_scale[layer, :, :, :a, None]
    return attend_rows(q, k, v, kv_valid[:, :a], scale)


def decode_attention_q8t_ref(q, k_cache, k_scale, v_cache, v_scale, kv_valid, layer: int, *,
                             scale: float, attend_len: int):
    """Plain version of ``decode_attention_q8t``: the scales (bf16 or f32)
    widened to f32, then ``decode_attention_q8_ref``."""
    return decode_attention_q8_ref(q, k_cache, k_scale.float(), v_cache, v_scale.float(),
                                   kv_valid, layer, scale=scale, attend_len=attend_len)


def tile_slots(head_dim: int, value_bytes: int) -> int:
    """Slots of one tile of the kernel's ring: K rows of ``head_dim`` values
    of ``value_bytes`` each filling ``STAGE_BYTES``."""
    return STAGE_BYTES // (head_dim * value_bytes)


@functools.lru_cache(maxsize=256)
def decode_plan(batch: int, kv_heads: int, attend_len: int, head_dim: int,
                value_bytes: int) -> tuple[int, int]:
    """(cluster, chunk): the blocks per (row, KV head) and the logical slots
    each walks, rank r taking [r * chunk, min((r + 1) * chunk, attend_len)).

    A block walks its slots in tiles of ``tile_slots`` slots. The cluster
    is the largest power of two, up to 8 blocks, that keeps the grid near
    ``TARGET_BLOCKS`` and gives each block a tile (on an H100, 2, 3, 4 and
    8 measured: 3 and wider clusters at batch 16 are slower; PERF.md §6);
    chunk is then a whole number of tiles, and the cluster shrinks so that
    no rank is left without a slot."""
    step = tile_slots(head_dim, value_bytes)
    want = min(MAX_CLUSTER, -(-TARGET_BLOCKS // (batch * kv_heads)), -(-attend_len // step))
    cluster = 1 << (max(1, want).bit_length() - 1)
    chunk = -(-attend_len // (cluster * step)) * step
    return -(-attend_len // chunk), chunk


class DecodeArgs(ctypes.Structure):
    """``mosstts::decode::Args`` of ``csrc/decode_kernel.cuh``, field for
    field: pointers, then ints, then strides in elements, then the scale."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "k_scale", "v_scale", "valid", "table",
                                        "out")]
        + [(n, ctypes.c_int) for n in ("layer", "H", "KV", "attend_len", "page_size", "chunk",
                                       "cluster")]
        + [(n, ctypes.c_longlong) for n in ("q_sb", "q_sh", "c_sl", "c_sb", "c_sh", "c_ss",
                                            "s_sl", "s_sb", "s_sh", "s_ss", "valid_sb",
                                            "table_sb", "o_sb", "o_sh")]
        + [("scale", ctypes.c_float)]
    )


def check_common(name: str, q, k, v, kv_valid, layer: int, attend_len: int, capacity: int,
                 value_dtype: torch.dtype, scales=(), scale_dtypes=(torch.float32,)) -> None:
    """The checks every decode wrapper makes before it passes pointers:
    dtypes, head dims, group size, layouts the vector loads take, the
    scales' dtype (one of ``scale_dtypes``, both alike) and layout, the
    layer, ``attend_len`` against the logical ``capacity``, and devices."""
    B, H, hd = q.shape
    L, _, KV, _, hdc = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != value_dtype or v.dtype != value_dtype:
        raise TypeError(f"{name}: dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}; the kernel "
                        f"takes a bf16 or f32 query and {value_dtype} values")
    if not supports(hd, H, KV):
        raise ValueError(f"{name}: head_dim {hd} (H={H}, KV={KV}) not supported")
    if hdc != hd or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    per16 = 16 // k.element_size()  # values in one 16-byte load
    if (k.stride() != v.stride() or k.stride(4) != 1 or q.stride(2) != 1
            or any(s % per16 for s in k.stride()[:4])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"{name}: k/v must share one layout with a contiguous head dim and "
                         "rows aligned to 16 bytes, and q's head dim must be contiguous")
    for s in scales:
        if (s.dtype not in scale_dtypes or s.dtype != scales[0].dtype
                or s.shape != k.shape[:4] or s.stride() != scales[0].stride()):
            raise ValueError(f"{name}: scales must be {tuple(k.shape[:4])} of one dtype in "
                             f"{scale_dtypes}, one layout")
    if not 0 <= layer < L or not 1 <= attend_len <= capacity:
        raise ValueError(f"{name}: layer {layer} of {L}, attend_len {attend_len} of {capacity}")
    if (kv_valid.dtype != torch.bool or kv_valid.shape[0] != B
            or kv_valid.shape[1] < attend_len or kv_valid.stride(1) != 1):
        raise ValueError(f"{name}: kv_valid must be bool (B, >= attend_len) "
                         "with contiguous slots")
    for t in (k, v, kv_valid, *scales):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices")


def launch(entry: str, q, k, v, kv_valid, layer: int, attend_len: int, scale: float, *,
           k_scale=None, v_scale=None, table: Optional[torch.Tensor] = None,
           extra: tuple = ()) -> torch.Tensor:
    """Fill ``DecodeArgs`` from checked tensors, allocate the output, and
    launch the C entry point ``entry`` on the current stream; ``extra`` ints
    go after the query dtype code."""
    B, H, hd = q.shape
    KV = k.shape[2]
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    cluster, chunk = decode_plan(B, KV, int(attend_len), hd, k.element_size())
    sc = k_scale.stride() if k_scale is not None else (0, 0, 0, 0)
    a = DecodeArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        k_scale=k_scale.data_ptr() if k_scale is not None else None,
        v_scale=v_scale.data_ptr() if v_scale is not None else None,
        valid=kv_valid.data_ptr(), table=table.data_ptr() if table is not None else None,
        out=out.data_ptr(),
        layer=int(layer), H=H, KV=KV, attend_len=int(attend_len),
        page_size=k.shape[3] if table is not None else 0, chunk=chunk, cluster=cluster,
        q_sb=q.stride(0), q_sh=q.stride(1),
        c_sl=k.stride(0), c_sb=k.stride(1), c_sh=k.stride(2), c_ss=k.stride(3),
        s_sl=sc[0], s_sb=sc[1], s_sh=sc[2], s_ss=sc[3],
        valid_sb=kv_valid.stride(0), table_sb=table.stride(0) if table is not None else 0,
        o_sb=out.stride(0), o_sh=out.stride(1), scale=float(scale),
    )
    rc = _entry(entry, len(extra))(ctypes.byref(a), B, hd, _DTYPE_CODES[q.dtype], *extra,
                                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out


def _on_cuda(name: str, q: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises for any other device."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type == "cuda"


def decode_attention(
    q: torch.Tensor,  # (B, H, hd) current-step queries
    k_cache: torch.Tensor,  # (L, B, KV, S, hd)
    v_cache: torch.Tensor,
    kv_valid: torch.Tensor,  # (B, >= attend_len) bool
    layer: int,
    *,
    scale: float,
    attend_len: int,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype."""
    if not _on_cuda("decode_attention", q):
        return decode_attention_ref(q, k_cache, v_cache, kv_valid, layer,
                                    scale=scale, attend_len=attend_len)
    check_common("decode_attention", q, k_cache, v_cache, kv_valid, layer, attend_len,
                 k_cache.shape[3], q.dtype)
    if k_cache.shape[1] != q.shape[0]:
        raise ValueError(f"decode_attention: cache batch {k_cache.shape[1]} != q batch {q.shape[0]}")
    out = launch("mosstts_decode_attention", q, k_cache, v_cache, kv_valid, layer, attend_len,
                 scale)
    global LAUNCHES
    LAUNCHES += 1
    return out


def decode_attention_q8(
    q: torch.Tensor,  # (B, H, hd) bf16 or f32
    k_cache: torch.Tensor,  # (L, B, KV, S, hd) int8
    k_scale: torch.Tensor,  # (L, B, KV, S) f32
    v_cache: torch.Tensor,  # (L, B, KV, S, hd) int8
    v_scale: torch.Tensor,  # (L, B, KV, S) f32
    kv_valid: torch.Tensor,  # (B, >= attend_len) bool
    layer: int,
    *,
    scale: float,
    attend_len: int,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype. Argument order as the JAX kernel's."""
    if not _on_cuda("decode_attention_q8", q):
        return decode_attention_q8_ref(q, k_cache, k_scale, v_cache, v_scale, kv_valid, layer,
                                       scale=scale, attend_len=attend_len)
    check_common("decode_attention_q8", q, k_cache, v_cache, kv_valid, layer, attend_len,
                 k_cache.shape[3], torch.int8, scales=(k_scale, v_scale))
    if k_cache.shape[1] != q.shape[0]:
        raise ValueError(f"decode_attention_q8: cache batch {k_cache.shape[1]} "
                         f"!= q batch {q.shape[0]}")
    out = launch("mosstts_decode_attention_q8", q, k_cache, v_cache, kv_valid, layer,
                 attend_len, scale, k_scale=k_scale, v_scale=v_scale)
    global LAUNCHES_Q8
    LAUNCHES_Q8 += 1
    return out


def decode_attention_q8t(
    q: torch.Tensor,  # (B, H, hd) bf16 or f32
    k_cache: torch.Tensor,  # (L, B, KV, S, hd) int8
    k_scale: torch.Tensor,  # (L, B, KV, S) bf16 or f32
    v_cache: torch.Tensor,  # (L, B, KV, S, hd) int8
    v_scale: torch.Tensor,  # (L, B, KV, S), k_scale's dtype
    kv_valid: torch.Tensor,  # (B, >= attend_len) bool
    layer: int,
    *,
    scale: float,
    attend_len: int,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype. Ports
    ``mosstts_tpu.ops.pallas.decode_attn.decode_attention_q8t`` with the
    scales in the untiled (L, B, KV, S) layout."""
    if not _on_cuda("decode_attention_q8t", q):
        return decode_attention_q8t_ref(q, k_cache, k_scale, v_cache, v_scale, kv_valid, layer,
                                        scale=scale, attend_len=attend_len)
    check_common("decode_attention_q8t", q, k_cache, v_cache, kv_valid, layer, attend_len,
                 k_cache.shape[3], torch.int8, scales=(k_scale, v_scale),
                 scale_dtypes=tuple(_DTYPE_CODES))
    if k_cache.shape[1] != q.shape[0]:
        raise ValueError(f"decode_attention_q8t: cache batch {k_cache.shape[1]} "
                         f"!= q batch {q.shape[0]}")
    out = launch("mosstts_decode_attention_q8t", q, k_cache, v_cache, kv_valid, layer,
                 attend_len, scale, k_scale=k_scale, v_scale=v_scale,
                 extra=(_DTYPE_CODES[k_scale.dtype],))
    global LAUNCHES_Q8T
    LAUNCHES_Q8T += 1
    return out


@functools.cache
def _entry(name: str, n_extra: int = 0):
    """The C entry point ``name``: (args*, B, hd, q dtype code, ``n_extra``
    more ints, stream)."""
    from . import _build

    i = ctypes.c_int
    return _build.kernel(name, [ctypes.POINTER(DecodeArgs), i, i, i] + [i] * n_extra
                         + [ctypes.c_void_p])
