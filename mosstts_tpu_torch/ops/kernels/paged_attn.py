"""Single-token decode attention over a shared page pool: the CUDA kernels of
``csrc/paged_attn.cu`` and their plain PyTorch versions.

Ports ``mosstts_tpu/ops/pallas/paged_attn.py``:

* ``paged_decode_attention``: the pool (L, NP, KV, P, hd) in bf16 or f32;
* ``paged_decode_attention_q8``: an int8 pool with f32 (L, NP, KV, P)
  scales, folded as in ``decode_attn.decode_attention_q8``.

Logical slot ``s`` of row ``b`` lives at pool page ``page_table[b, s // P]``,
in-page offset ``s % P``. Unallocated table entries point at the reserved
trash page 0; validity rides ``kv_valid`` over logical slots, exactly as for
the linear cache. ``attend_len`` must be a multiple of the page size, as the
JAX kernel asserts. The kernels read the table in device memory; the plain
versions gather whole pages into a linear (B, KV, attend_len, hd) view, as
the JAX package's non-kernel path does (``nn/qwen3.py:406-418``).

Each wrapper runs its plain version for CPU tensors and its kernel for CUDA
tensors, never falling back from one to the other, raises on a shape the
kernel does not take, and counts its launches.
"""
from __future__ import annotations

import torch

from .decode_attn import _on_cuda, attend_rows, check_common, launch

LAUNCHES = 0  # paged_decode_attention kernel launches since the count was last set to 0
LAUNCHES_Q8 = 0  # paged_decode_attention_q8 kernel launches


def gather_pages(pool_layer: torch.Tensor, page_table: torch.Tensor, attend_len: int):
    """One layer of a pool, (NP, KV, P, ...), read through the table's first
    ``attend_len // P`` entries into the linear layout (B, KV, attend_len, ...)."""
    P = pool_layer.shape[2]
    g = pool_layer[page_table[:, : attend_len // P].long()]  # (B, n, KV, P, ...)
    g = g.movedim(2, 1)  # (B, KV, n, P, ...)
    return g.reshape(g.shape[:2] + (attend_len,) + g.shape[4:])


def scatter_pages(x: torch.Tensor, page_table: torch.Tensor, num_pages: int, fill=0):
    """The inverse of ``gather_pages`` over all layers: a linear cache
    (L, B, KV, S, ...) laid into a new pool (L, num_pages, KV, P, ...) with
    P = S // MP. Logical pages whose table entry is the trash page 0 are not
    stored; the pool holds ``fill`` wherever nothing was stored."""
    L, B, KV, S = x.shape[:4]
    MP = page_table.shape[1]
    P = S // MP
    pool = torch.full((L, num_pages, KV, P) + x.shape[4:], fill, dtype=x.dtype, device=x.device)
    blocks = x.reshape((L, B, KV, MP, P) + x.shape[4:]).transpose(2, 3)  # (L, B, MP, KV, P, ...)
    live = page_table != 0
    pool[:, page_table[live].long()] = blocks[:, live]
    return pool


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, kv_valid, layer: int, *,
                               scale: float, attend_len: int):
    """Plain version: gather the attended pages, then the linear softmax."""
    return attend_rows(q, gather_pages(k_pool[layer], page_table, attend_len),
                       gather_pages(v_pool[layer], page_table, attend_len),
                       kv_valid[:, :attend_len], scale)


def paged_decode_attention_q8_ref(q, k_pool, k_scale, v_pool, v_scale, page_table, kv_valid,
                                  layer: int, *, scale: float, attend_len: int):
    """Plain version of the int8 pool: gather values and scales, dequantize
    to f32, then the linear softmax."""
    k = (gather_pages(k_pool[layer], page_table, attend_len).float()
         * gather_pages(k_scale[layer], page_table, attend_len)[..., None])
    v = (gather_pages(v_pool[layer], page_table, attend_len).float()
         * gather_pages(v_scale[layer], page_table, attend_len)[..., None])
    return attend_rows(q, k, v, kv_valid[:, :attend_len], scale)


def _check_table(name: str, q, k_pool, page_table, attend_len: int) -> None:
    P = k_pool.shape[3]
    if (page_table.dtype != torch.int32 or page_table.ndim != 2
            or page_table.shape[0] != q.shape[0] or page_table.stride(1) != 1
            or page_table.device != q.device):
        raise ValueError(f"{name}: page_table must be int32 (B, MP) on q's device "
                         "with contiguous entries")
    if attend_len % P:
        raise ValueError(f"{name}: attend_len {attend_len} is not a multiple of the "
                         f"page size {P}")


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (L, NP, KV, P, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    kv_valid: torch.Tensor,  # (B, >= attend_len) bool over logical slots
    layer: int,
    *,
    scale: float,
    attend_len: int,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype."""
    if not _on_cuda("paged_decode_attention", q):
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table, kv_valid, layer,
                                          scale=scale, attend_len=attend_len)
    name = "paged_decode_attention"
    check_common(name, q, k_pool, v_pool, kv_valid, layer, attend_len,
                 page_table.shape[1] * k_pool.shape[3], q.dtype)
    _check_table(name, q, k_pool, page_table, attend_len)
    out = launch("mosstts_paged_decode_attention", q, k_pool, v_pool, kv_valid, layer,
                 attend_len, scale, table=page_table)
    global LAUNCHES
    LAUNCHES += 1
    return out


def paged_decode_attention_q8(
    q: torch.Tensor,  # (B, H, hd) bf16 or f32
    k_pool: torch.Tensor,  # (L, NP, KV, P, hd) int8
    k_scale: torch.Tensor,  # (L, NP, KV, P) f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    kv_valid: torch.Tensor,  # (B, >= attend_len) bool over logical slots
    layer: int,
    *,
    scale: float,
    attend_len: int,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype. Argument order as the JAX kernel's."""
    if not _on_cuda("paged_decode_attention_q8", q):
        return paged_decode_attention_q8_ref(q, k_pool, k_scale, v_pool, v_scale, page_table,
                                             kv_valid, layer, scale=scale, attend_len=attend_len)
    name = "paged_decode_attention_q8"
    check_common(name, q, k_pool, v_pool, kv_valid, layer, attend_len,
                 page_table.shape[1] * k_pool.shape[3], torch.int8, scales=(k_scale, v_scale))
    _check_table(name, q, k_pool, page_table, attend_len)
    out = launch("mosstts_paged_decode_attention_q8", q, k_pool, v_pool, kv_valid, layer,
                 attend_len, scale, k_scale=k_scale, v_scale=v_scale, table=page_table)
    global LAUNCHES_Q8
    LAUNCHES_Q8 += 1
    return out
