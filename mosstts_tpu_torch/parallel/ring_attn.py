"""Ring attention: causal GQA attention with the sequence split over a mesh
axis, the K/V blocks passed around the ring and folded by online softmax.

Ports ``mosstts_tpu/parallel/ring_attn.py``: ``ring_attention_shard``,
``zigzag_order`` and ``ring_gqa_attention``. Each rank keeps its query
block and folds one K/V block per round; between rounds the blocks (with
their positions and validity, which ride with them) move one rank along the
ring by ``batch_isend_irecv``. The fold runs in float32. A block that masks
every (query, key) pair of this rank is skipped (a host read of the mask;
JAX skips it under ``lax.cond``), so under the zigzag layout every rank
skips as many rounds; a query row with no valid key returns 0. JAX computes
the body with einsums, not a kernel, and so does this port (plain
``torch`` products).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.attention import NEG_INF
from ..ops.collectives import Axis, gather
from .mesh import mesh_axis


def _rotate(x: torch.Tensor, ax: Axis, ranks) -> torch.Tensor:
    """``x`` sent to the next rank of the ring, the previous rank's returned."""
    out = torch.empty_like(x)
    nxt, prv = ranks[(ax.index + 1) % ax.size], ranks[(ax.index - 1) % ax.size]
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x.contiguous(), nxt),
                                        dist.P2POp(dist.irecv, out, prv)]):
        work.wait()
    return out


def ring_attention_shard(q: torch.Tensor,  # (B, Tq, H, hd) this rank's query block
                         k: torch.Tensor,  # (B, Tk, KV, hd) this rank's key block
                         v: torch.Tensor,
                         q_positions: torch.Tensor,  # (B, Tq) absolute positions
                         kv_positions: torch.Tensor,  # (B, Tk)
                         kv_valid: torch.Tensor,  # (B, Tk) bool
                         *, scale: float, axis: Axis, ranks, window: Optional[int] = None
                         ) -> torch.Tensor:
    """Ports ``mosstts_tpu.parallel.ring_attn.ring_attention_shard``: this
    rank's (B, Tq, H, hd) output after ``axis.size`` rounds. ``ranks`` are
    the global ranks of the axis in ring order."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    dev = q.device
    qf = q.float().reshape(B, Tq, KV, G, hd) * scale
    m = torch.full((B, KV, G, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Tq, hd), dtype=torch.float32, device=dev)
    # what rides the ring: K and V in one tensor, positions and validity in another
    kv = torch.stack([k, v])
    meta = torch.stack([kv_positions.to(torch.int32), kv_valid.to(torch.int32)])
    for step in range(axis.size):
        pos_blk, valid_blk = meta[0], meta[1].bool()
        rel = q_positions[:, :, None] - pos_blk[:, None, :]  # (B, Tq, Tk)
        mask = (rel >= 0) & valid_blk[:, None, :]
        if window is not None:
            mask = mask & (rel < window)
        if bool(mask.any()):  # a fully masked block adds nothing
            mk = mask[:, None, None]
            scores = torch.einsum("bqkgh,bskh->bkgqs", qf, kv[0].float())
            scores = torch.where(mk, scores, NEG_INF)
            new_m = torch.maximum(m, scores.amax(dim=-1))
            # zero the masked entries: a row whose keys in this block are all
            # masked has new_m == NEG_INF and exp(0) == 1 there
            p = torch.where(mk, torch.exp(scores - new_m[..., None]), 0.0)
            corr = torch.exp(m - new_m)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, kv[1].float())
            l = l * corr + p.sum(dim=-1)
            m = new_m
        if step + 1 < axis.size:
            kv, meta = _rotate(kv, axis, ranks), _rotate(meta, axis, ranks)
    out = acc / l.clamp_min(1e-30)[..., None]  # rows with no valid key -> 0
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)


def zigzag_order(T: int, n: int) -> np.ndarray:
    """Ports ``mosstts_tpu.parallel.ring_attn.zigzag_order``: the sequence
    order of the striped layout, rank d holding stripes d and 2n-1-d, so
    every rank's causal work is equal."""
    if T % (2 * n):
        raise ValueError(f"zigzag needs T % (2*{n}) == 0, got T={T}")
    S = T // (2 * n)
    parts = []
    for d in range(n):
        parts.append(np.arange(d * S, (d + 1) * S))
        e = 2 * n - 1 - d
        parts.append(np.arange(e * S, (e + 1) * S))
    return np.concatenate(parts)


def ring_gqa_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       q_positions: torch.Tensor, kv_positions: torch.Tensor,
                       kv_valid: torch.Tensor, scale: float, axis: str = "model",
                       window: Optional[int] = None, layout: str = "contiguous") -> torch.Tensor:
    """Ports ``mosstts_tpu.parallel.ring_attn.ring_gqa_attention``: causal
    GQA attention of the whole (B, T, ...) arrays, which every rank of
    ``mesh`` holds, with T split over ``axis``: each rank folds its block
    of queries around the ring, and the blocks are gathered back, so every
    rank returns the whole (B, T, H, hd) output. T must divide by the
    axis' size; ``layout="zigzag"`` needs ``T % (2 * size) == 0``."""
    ax = mesh_axis(mesh, axis)
    n, T = ax.size, q.shape[1]
    if T % n != 0:
        raise ValueError(f"T={T} not divisible by mesh axis {axis!r}={n}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    order = None
    if layout == "zigzag" and n > 1:
        order = torch.as_tensor(zigzag_order(T, n), device=q.device)
        q, k, v, q_positions, kv_positions, kv_valid = (
            x.index_select(1, order) for x in (q, k, v, q_positions, kv_positions, kv_valid))
    coord = [mesh.get_local_rank(d) for d in mesh.mesh_dim_names]
    dim = mesh.mesh_dim_names.index(axis)
    ranks = []
    for i in range(n):
        c = list(coord)
        c[dim] = i
        ranks.append(int(mesh.mesh[tuple(c)]))
    Tb = T // n
    blk = slice(ax.index * Tb, (ax.index + 1) * Tb)
    out = ring_attention_shard(q[:, blk], k[:, blk], v[:, blk], q_positions[:, blk],
                               kv_positions[:, blk], kv_valid[:, blk], scale=scale, axis=ax,
                               ranks=ranks, window=window)
    out = gather(out, 1, ax)
    if order is not None:
        out = out.index_select(1, torch.argsort(order))
    return out
