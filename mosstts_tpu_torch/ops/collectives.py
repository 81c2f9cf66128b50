"""The collectives of the port's parallel paths, over ``torch.distributed``.

The JAX package states shardings and lets GSPMD insert the collectives; the
port writes them out (Megatron-style tensor parallelism), since its
hand-written kernels have no sharding rules and its decode steps are CUDA
graphs. Every rank of a mesh runs the same program (SPMD): one process per
device, NCCL on the card, gloo on the CPU.

``Axis`` is one mesh axis as a rank sees it: its process group, its size and
the rank's index along it. ``parallel.mesh.shard_params`` records the axes on
every submodule of the model it shards (``axis_of``) and, per parameter, the
dimensions it split (``sharded_dims``); the forward passes read them.

The autograd pairs (training differentiates through them):

* ``enter``: identity forward, ``all_reduce`` backward. At the input of a
  column-parallel product (each rank's gradient of a replicated input is a
  partial sum), and on a replicated weight applied to this rank's heads only
  (``q_norm``/``k_norm``).
* ``reduce``: ``all_reduce`` forward, identity backward, at a row-parallel
  output (``torch.distributed.nn.functional.all_reduce`` would all-reduce the
  gradient as well: every rank's downstream is replicated, so the gradient is
  already whole on each).
* ``gather``: ``all_gather`` along a dimension forward, this rank's block of
  the gradient backward (vocab- and codebook-parallel logits).

Outside autograd (inference, CUDA-graph capture) each is one in-place
collective or none. With no axis (an unsharded model) each returns its input.
At world size 1 the collectives still run, through the same backend.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis seen from this rank."""

    name: str
    group: object  # torch.distributed ProcessGroup
    size: int
    index: int  # this rank's coordinate along the axis


def axis_of(module, name: str) -> Optional[Axis]:
    """The mesh axis ``name`` a sharded model's ``module`` runs over, or None."""
    return getattr(module, "_mesh_axes", {}).get(name)


def sharded_dims(module, param: str) -> Dict[int, str]:
    """{dimension: axis name} of the dimensions ``shard_params`` split in
    ``module``'s own parameter ``param`` (empty: replicated)."""
    return getattr(module, "_mesh_dims", {}).get(param, {})


LAUNCHES = 0  # collectives issued by reduce and gather (``kernels/launches.COLLECTIVES``)


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


# torch >= 2.12 names it all_gather_single (the old name warns there)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather_raw(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((ax.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _ALL_GATHER(out, x, group=ax.group)
    out = out.view((ax.size,) + tuple(x.shape))
    d = dim % x.ndim
    # (n, ..., x_d, ...) -> (..., n * x_d, ...): block r of dim d is rank r's
    return out.movedim(0, d).reshape(x.shape[:d] + (ax.size * x.shape[d],) + x.shape[d + 1:])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax, ctx.n = dim, ax, x.shape[dim]
        y = _gather_raw(x, dim, ax)
        return y if y._base is None else y.clone()  # a function returns no view

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n).contiguous(), None, None


def enter(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Identity; in backward, the gradient summed over ``ax``."""
    if ax is None or not _records(x):
        return x
    return _Enter.apply(x, ax.group)


def reduce(x: torch.Tensor, ax: Optional[Axis], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or ``op``) over ``ax``; in backward, the gradient as it is."""
    global LAUNCHES
    if ax is None:
        return x
    LAUNCHES += 1
    if _records(x):
        if op != dist.ReduceOp.SUM:
            raise ValueError("only a sum is differentiable")
        return _Reduce.apply(x, ax.group)
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=ax.group)
    return x


def gather(x: torch.Tensor, dim: int, ax: Optional[Axis]) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim``, joined in rank order; in
    backward, this rank's block of the gradient."""
    global LAUNCHES
    if ax is None:
        return x
    LAUNCHES += 1
    if _records(x):
        return _Gather.apply(x, dim, ax)
    return _gather_raw(x, dim, ax)


def full_param(module, name: str, ax: Optional[Axis]) -> torch.Tensor:
    """``module``'s parameter ``name`` whole: gathered along the dimension
    ``ax`` split (its gradient flows back to this rank's block), or as it is
    when replicated. For tables a forward indexes per channel."""
    p = getattr(module, name)
    for d, axis in sharded_dims(module, name).items():
        if ax is not None and axis == ax.name:
            return gather(p, d, ax)
    return p


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Rows ``ids`` of a table whose rows are split over ``ax`` (this rank
    holds the block ``[index * n, (index + 1) * n)``), zero where another
    rank holds the row. The caller sums the ranks' results (``reduce``)."""
    if ax is None:
        return table[ids]
    n = table.shape[0]
    local = ids - ax.index * n
    ok = (local >= 0) & (local < n)
    rows = table[torch.where(ok, local, 0)]
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


class _View:
    """Attributes of a module, some parameters gathered whole."""


def whole_view(module, ax: Optional[Axis], keep=()):
    """``module``'s parameters as attributes, those split over ``ax``
    gathered whole (``full_param``), and its submodules the same way,
    except those named in ``keep``, which stay as they are (the stacks a
    forward runs tensor-parallel). With no axis, ``module`` itself."""
    if ax is None:
        return module
    view = _View()
    view._mesh_axes = getattr(module, "_mesh_axes", {})
    for name, _ in module.named_parameters(recurse=False):
        setattr(view, name, full_param(module, name, ax))
    for name, child in module.named_children():
        setattr(view, name, child if name in keep else whole_view(child, ax))
    return view
