"""Qwen3-family decoder backbone over layer-stacked parameters.

Ports ``mosstts_tpu/nn/qwen3.py``: the four KV caches (``KVCache``,
``QuantKVCache``, ``PagedKVCache``, ``QuantPagedKVCache``) and their
``init_*`` functions, ``_quantize_kv_block``, ``init_qwen3_params`` and
``qwen3_forward`` with prefill at a scalar offset, single-token decode at a
scalar offset or at (B,) per-row cursors, the int8 and paged caches, and the
ring cache with explicit ``kv_positions`` and ``attn_window`` that the codec
uses. Layouts are the JAX package's: weights (in, out) stacked on a leading
L axis, the linear cache (L, B, KV, S, hd), the page pool (L, NP, KV, P, hd)
with a (B, MP) table. Positions are absolute slot indices whatever the left
padding; padding rides ``kv_valid``.

Where the JAX package calls its Pallas kernels, this module calls the CUDA
kernels of ``ops/kernels``: a multi-token forward with linear slots and a
scalar offset goes through ``flash_attention`` (an int8 or paged cache
filled from slot 0 attends the prompt's own k/v through it); a single-token
step with linear slots and no window goes through the decode kernel of its
cache (``decode_attention``, ``decode_attention_q8``,
``paged_decode_attention``, ``paged_decode_attention_q8``). On CUDA tensors
these are the only routes: a shape a kernel does not take raises in its
wrapper. The wrappers run their plain versions on CPU tensors. The codec's
ring cache and the no-cache pass stay on the plain attention, as in JAX.

The stacked matmul weights may be int8 ``QuantWeight``s (``ops/quant.py``):
``lay.wq[li]`` is then a view of layer ``li``'s values and scales, which
``dense`` hands to the W8A16 kernel at that layer's offset, with no copy.

The caches are written in place (slice, ``index_copy_`` or indexed store
into the preallocated buffers): no copy of a cache per step. The quantize
and scatter of a cache write are plain PyTorch, as in JAX.
``output_hidden_states``, ``remat``, ``use_rope=False`` and
``final_norm=False`` are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from ..core.config import Qwen3Config
from ..ops.attention import gqa_attention, gqa_attention_kvmajor
from ..ops.basic import apply_rope, dense, put_drop_, rms_norm, rope_cos_sin, swiglu
from ..ops.kernels import decode_attn, flash, paged_attn


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class KVCache(NamedTuple):
    """Ports ``mosstts_tpu.nn.qwen3.KVCache``: layer-stacked (L, B, KV, S, hd)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


class QuantKVCache(NamedTuple):
    """Ports ``mosstts_tpu.nn.qwen3.QuantKVCache``: int8 (L, B, KV, S, hd)
    values with one f32 absmax scale per (layer, row, KV head, slot)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, KV, S) f32
    v_scale: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


class PagedKVCache(NamedTuple):
    """Ports ``mosstts_tpu.nn.qwen3.PagedKVCache``: a pool (L, NP, KV, P, hd)
    shared by all rows; row b's logical slot s lives at (table[b, s // P],
    s % P). Unallocated table entries point at the trash page 0, which
    absorbs idle rows' writes; validity rides ``kv_valid`` over logical
    slots."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor  # (B, MP) int32: logical page -> pool page

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_len(self) -> int:
        return self.table.shape[1] * self.k.shape[3]


class QuantPagedKVCache(NamedTuple):
    """Ports ``mosstts_tpu.nn.qwen3.QuantPagedKVCache``: the int8 pool with
    (L, NP, KV, P) f32 scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_len(self) -> int:
        return self.table.shape[1] * self.k.shape[3]


def init_kv_cache(cfg: Qwen3Config, batch: int, max_len: int, *,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """Ports ``mosstts_tpu.nn.qwen3.init_kv_cache``."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_quant_kv_cache(cfg: Qwen3Config, batch: int, max_len: int, *,
                        device=None) -> QuantKVCache:
    """Ports ``mosstts_tpu.nn.qwen3.init_quant_kv_cache``."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return QuantKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device))


def init_paged_kv_cache(cfg: Qwen3Config, batch: int, max_len: int, num_pages: int, *,
                        page_size: int = 128, dtype=torch.bfloat16, quant: bool = False,
                        device=None):
    """Ports ``mosstts_tpu.nn.qwen3.init_paged_kv_cache``: ``max_len`` is the
    logical per-row capacity (the table width times ``page_size``);
    ``num_pages`` the pool size, trash page 0 included."""
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
    shape = (cfg.num_hidden_layers, num_pages, cfg.num_key_value_heads, page_size,
             cfg.head_dim)
    table = torch.zeros((batch, max_len // page_size), dtype=torch.int32, device=device)
    if quant:
        return QuantPagedKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:4], dtype=torch.float32, device=device),
            torch.zeros(shape[:4], dtype=torch.float32, device=device), table)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device), table)


def _quantize_kv_block(x: torch.Tensor):
    """Ports ``mosstts_tpu.nn.qwen3._quantize_kv_block``: (B, KV, T, hd) ->
    int8 values and (B, KV, T) f32 absmax scales; round half to even, then
    clip to +-127."""
    xf = x.float()
    sc = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc


class Qwen3Layers(nn.Module):
    """The per-layer weights, each stacked on a leading L axis (JAX names)."""

    NORMS = ("ln1", "ln2", "q_norm", "k_norm")

    def __init__(self, cfg: Qwen3Config, dtype, device):
        super().__init__()
        L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
        shapes = {
            "ln1": (L, D), "ln2": (L, D),
            "wq": (L, D, cfg.q_dim), "wk": (L, D, cfg.kv_dim), "wv": (L, D, cfg.kv_dim),
            "wo": (L, cfg.q_dim, D),
            "q_norm": (L, cfg.head_dim), "k_norm": (L, cfg.head_dim),
            "w_gate": (L, D, I), "w_up": (L, D, I), "w_down": (L, I, D),
        }
        for name, shape in shapes.items():
            self.register_parameter(name, empty_param(shape, dtype, device))


class Qwen3Params(nn.Module):
    """Ports the ``init_qwen3_params`` pytree: ``layers``, ``final_norm`` and,
    when ``with_embed``, ``embed`` (vocab, D)."""

    def __init__(self, cfg: Qwen3Config, *, dtype=torch.float32, device=None,
                 with_embed: bool = True):
        super().__init__()
        self.layers = Qwen3Layers(cfg, dtype, device)
        self.final_norm = empty_param((cfg.hidden_size,), dtype, device)
        if with_embed:
            self.embed = empty_param((cfg.vocab_size, cfg.hidden_size), dtype, device)


@torch.no_grad()
def fill_qwen3_params_(params: Qwen3Params, generator: torch.Generator) -> Qwen3Params:
    """Initialise in place: norms at 1, matrices N(0, 0.02), drawn where the
    parameters live with ``generator`` (on that device)."""
    for name, p in params.named_parameters():
        if name.rsplit(".", 1)[-1] in Qwen3Layers.NORMS + ("final_norm",):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return params


def init_qwen3_params(cfg: Qwen3Config, *, generator: torch.Generator, dtype=torch.float32,
                      device=None, with_embed: bool = True) -> Qwen3Params:
    """Ports ``mosstts_tpu.nn.qwen3.init_qwen3_params``, drawing on
    ``device``. The draws differ from JAX's; parity tests load JAX weights
    through ``utils.convert`` instead."""
    return fill_qwen3_params_(
        Qwen3Params(cfg, dtype=dtype, device=device, with_embed=with_embed), generator)


def _write_block(buf_layer: torch.Tensor, blk: torch.Tensor,
                 offset: Union[int, torch.Tensor]) -> None:
    """Store a (B, KV, T, ...) block into one linear cache layer at slot
    ``offset`` in place. A tensor offset stays on the device (no host sync)."""
    T = blk.shape[2]
    if isinstance(offset, torch.Tensor):
        idx = offset.long() + torch.arange(T, device=blk.device)
        buf_layer.index_copy_(2, idx, blk.to(buf_layer.dtype))
    else:
        buf_layer[:, :, offset:offset + T] = blk


def _write_targets(cache, offset: Union[int, torch.Tensor], B: int, T: int, device):
    """Where the T new entries of each row go in one cache layer: (index,
    keep), the index (rows (B, T), all KV heads, slots (B, T)) for
    ``put_drop_``. Rows index the batch (linear cache) or pool pages (paged
    cache, through the table); slots the cache slot or in-page offset.
    Logical slots s >= the capacity S are dropped, as JAX's ``mode="drop"``
    (an idle server row's cursor runs past S): keep is False and the entry
    stands in at slot s - T, below the row's first new slot, so it never
    meets a kept entry of its row (on the trash page 0 of a paged cache
    entries may meet; nothing reads that page)."""
    S = cache.max_len
    if T > S:
        raise ValueError(f"{T} new positions do not fit a cache of {S} slots")
    off = (offset.long().expand(B) if isinstance(offset, torch.Tensor)
           else torch.full((B,), offset, dtype=torch.long, device=device))
    s = off[:, None] + torch.arange(T, device=device)  # (B, T) logical slots
    keep = s < S
    s = torch.where(keep, s, (s - T).clamp(0, S - 1))
    if isinstance(cache, (PagedKVCache, QuantPagedKVCache)):
        P = cache.page_size
        return (cache.table.gather(1, s // P).long(), slice(None), s % P), keep
    return (torch.arange(B, device=device)[:, None].expand(B, T), slice(None), s), keep


def _store(buf: torch.Tensor, li: int, blk: torch.Tensor, offset, targets) -> None:
    """Write a (B, KV, T, ...) block into layer ``li`` of ``buf`` in place:
    at ``offset`` of a linear cache, or at ``targets`` (``_write_targets``)
    in one masked scatter."""
    if targets is None:
        _write_block(buf[li], blk, offset)
        return
    index, keep = targets
    put_drop_(buf[li], index, blk.movedim(2, 1), keep)  # entries (B, T, KV, ...)


def _read(cache, buf: torch.Tensor, li: int, a_len: int) -> torch.Tensor:
    """The attended prefix of one layer in the linear layout (B, KV, a_len,
    ...): a view of a linear cache, a page gather of a paged one."""
    if isinstance(cache, (PagedKVCache, QuantPagedKVCache)):
        return paged_attn.gather_pages(buf[li], cache.table, a_len)
    return buf[li, :, :, :a_len]


def qwen3_forward(
    params: Qwen3Params,
    cfg: Qwen3Config,
    inputs_embeds: torch.Tensor,  # (B, T, D)
    *,
    positions: torch.Tensor,  # (B, T) int32 absolute positions (== cache slots)
    kv_valid: torch.Tensor,  # (B, S) bool validity of cache slots (S=T with no cache)
    cache=None,  # KVCache | QuantKVCache | PagedKVCache | QuantPagedKVCache
    cache_offset: Union[int, torch.Tensor] = 0,  # int, 0-dim tensor, or (B,) row cursors
    kv_positions: Optional[torch.Tensor] = None,
    attn_window: Optional[int] = None,
    attend_len: Optional[int] = None,
):
    """Ports ``mosstts_tpu.nn.qwen3.qwen3_forward``. Returns
    (hidden (B, T, D), cache or None); the cache is updated in place.

    ``kv_positions`` gives the cache slots' absolute positions (ring and
    sliding-window caches); by default slot == position. ``attend_len``
    restricts attention reads to the first ``attend_len`` cache slots (a
    multiple of the page size for a paged cache). A (B,) ``cache_offset``
    gives each row its own write cursor; writes past the capacity drop."""
    B, T, D = inputs_embeds.shape
    hd, H, KV = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    scale = hd ** -0.5
    eps = cfg.rms_norm_eps
    dev = inputs_embeds.device
    per_row = isinstance(cache_offset, torch.Tensor) and cache_offset.ndim == 1
    quant = isinstance(cache, (QuantKVCache, QuantPagedKVCache))
    paged = isinstance(cache, (PagedKVCache, QuantPagedKVCache))
    linear_slots = kv_positions is None
    if per_row and T > 1 and dev.type == "cuda":
        # the flash kernel takes one q_start for the batch; JAX takes its
        # einsum path here, which the card does not run silently
        raise NotImplementedError("a multi-token forward with per-row cursors has no "
                                  "kernel on the card")

    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)

    use_flash = linear_slots and cache is not None and not per_row
    if kv_positions is None:
        kv_positions = (torch.arange(cache.max_len, dtype=torch.int32, device=dev)[None]
                        .expand(B, cache.max_len) if cache is not None else positions)
    a_len = None
    if cache is not None:
        a_len = attend_len if (attend_len is not None and attend_len < cache.max_len) \
            else cache.max_len
        if paged and a_len % cache.page_size:
            raise ValueError(f"attend_len {a_len} is not a multiple of the page size "
                             f"{cache.page_size}")
    kv_valid_a = kv_valid[:, :a_len] if a_len is not None else kv_valid
    kv_positions = kv_positions[:, :a_len] if a_len is not None else kv_positions
    use_decode_kernel = cache is not None and T == 1 and linear_slots and attn_window is None
    # int8/paged prefill into a fresh cache: the prompt attends its own k/v
    # (exact, no gather); only the cache write is quantized or scattered
    attend_fresh = ((quant or paged) and T > 1 and linear_slots and not per_row
                    and isinstance(cache_offset, int) and cache_offset == 0)
    targets = (_write_targets(cache, cache_offset, B, T, dev)
               if cache is not None and (per_row or paged) else None)

    def attend(q, k_all, v_all, kv_major: bool):
        if use_flash:
            out = flash.flash_attention(q, k_all, v_all, kv_valid_a, positions[0, 0],
                                        scale=scale, window=attn_window, kv_major=kv_major)
        else:
            fn = gqa_attention_kvmajor if kv_major else gqa_attention
            out = fn(q, k_all, v_all, q_positions=positions, kv_positions=kv_positions,
                     kv_valid=kv_valid_a, scale=scale, window=attn_window)
        return out.reshape(B, T, H * hd)

    def decode(q1, li):  # (B, H, hd) -> (B, H, hd) through the cache's kernel
        kw = dict(scale=scale, attend_len=a_len)
        if paged and quant:
            return paged_attn.paged_decode_attention_q8(
                q1, cache.k, cache.k_scale, cache.v, cache.v_scale, cache.table, kv_valid_a,
                li, **kw)
        if paged:
            return paged_attn.paged_decode_attention(
                q1, cache.k, cache.v, cache.table, kv_valid_a, li, **kw)
        if quant:
            return decode_attn.decode_attention_q8(
                q1, cache.k, cache.k_scale, cache.v, cache.v_scale, kv_valid_a, li, **kw)
        return decode_attn.decode_attention(q1, cache.k, cache.v, kv_valid_a, li, **kw)

    lay = params.layers
    hidden = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        x = rms_norm(hidden, lay.ln1[li], eps)
        q = rms_norm(dense(x, lay.wq[li]).reshape(B, T, H, hd), lay.q_norm[li], eps)
        k = rms_norm(dense(x, lay.wk[li]).reshape(B, T, KV, hd), lay.k_norm[li], eps)
        v = dense(x, lay.wv[li]).reshape(B, T, KV, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache is not None:
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (B, KV, T, hd)
            if quant:
                (kq, ks), (vq, vs) = _quantize_kv_block(kt), _quantize_kv_block(vt)
                for buf, blk in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                                 (cache.v_scale, vs)):
                    _store(buf, li, blk, cache_offset, targets)
            else:
                _store(cache.k, li, kt, cache_offset, targets)
                _store(cache.v, li, vt, cache_offset, targets)
            if attend_fresh:
                attn = flash.flash_attention(q, k, v, kv_valid[:, :T], positions[0, 0],
                                             scale=scale, window=attn_window).reshape(B, T, H * hd)
            elif use_decode_kernel:
                attn = decode(q[:, 0], li).reshape(B, 1, H * hd)
            else:
                k_all, v_all = _read(cache, cache.k, li, a_len), _read(cache, cache.v, li, a_len)
                if quant:
                    k_all = k_all.float() * _read(cache, cache.k_scale, li, a_len)[..., None]
                    v_all = v_all.float() * _read(cache, cache.v_scale, li, a_len)[..., None]
                attn = attend(q, k_all, v_all, kv_major=True)
        else:
            attn = attend(q, k, v, kv_major=False)
        hidden = hidden + dense(attn, lay.wo[li])
        x = rms_norm(hidden, lay.ln2[li], eps)
        hidden = hidden + swiglu(x, lay.w_gate[li], lay.w_up[li], lay.w_down[li])

    return rms_norm(hidden, params.final_norm, eps), cache
