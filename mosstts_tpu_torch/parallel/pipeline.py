"""GPipe pipeline parallelism over a ``"stage"`` mesh axis.

Ports ``mosstts_tpu/parallel/pipeline.py``: ``make_pp_mesh``,
``split_stages`` and ``pipelined_qwen3_forward``. The layer stack is split
into S contiguous stages, one per rank along ``"stage"``; the batch into M
microbatches. The schedule is JAX's: M + S - 1 ticks, stage s running its
layers on microbatch t - s at tick t and handing the activations to stage
s + 1 (``batch_isend_irecv`` to the neighbour). A stage with no microbatch
at a tick (the fill and drain bubbles) runs nothing, where JAX computes and
discards. The last stage's outputs are broadcast over ``"stage"`` and the
final norm applied on every rank, so the result equals
``qwen3_forward(...)[0]`` on every rank. A ``("stage", "model")`` mesh
runs each stage's layers tensor-parallel over ``"model"``
(``parallel/mesh.shard_params``).

Training differentiates through the schedule: each hand-over is one
autograd function whose backward sends the gradient back along the reversed
ring. The hand-overs of a rank are chained by a token (each takes the
previous one's), so every rank's backward runs them in the reverse order of
the ticks, whatever order the autograd engine picks among independent
nodes, and the sends and receives of two neighbours meet in order. The loss
is computed once: the broadcast's backward takes the last stage's gradient
only, so a rank that computes the loss from the broadcast output too (every
rank does, the heads being replicated) adds nothing twice. The gradients of
what a stage does not use reach every rank summed over ``"stage"``: the
stage inputs (the embeddings, used on stage 0) and, when every rank holds
the whole stack, the layer stacks, in one function at the head of the
chain, whose backward therefore runs after the rank's last hand-over. So
every rank's replicated copies see the same gradient. A stack already split
over ``"stage"`` (the trainer's, ``TTSTrainer(pipeline=)``) keeps its own
gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..core.config import Qwen3Config
from ..nn.qwen3 import qwen3_forward
from ..ops.basic import rms_norm
from .mesh import _init_default_group, mesh_axis


def make_pp_mesh(n_stages: int, model: int = 1, device: str = "cuda"):
    """Ports ``mosstts_tpu.parallel.pipeline.make_pp_mesh``: a ``("stage",)``
    mesh of the world's ranks, or ``("stage", "model")`` with ``model`` > 1
    (rank ``s * model + m`` at (s, m)). The world must hold ``n_stages *
    model`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    _init_default_group(device)
    n, world = n_stages * model, dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if world != n:
        raise ValueError(f"a pipeline mesh spans the world: {n} ranks, the world has {world}")
    if model == 1:
        return DeviceMesh(device, torch.arange(n), mesh_dim_names=("stage",))
    return DeviceMesh(device, torch.arange(n).reshape(n_stages, model),
                      mesh_dim_names=("stage", "model"))


def split_stages(layer_params, n_stages: int) -> Dict[str, torch.Tensor]:
    """Ports ``mosstts_tpu.parallel.pipeline.split_stages``: stacked layer
    weights (a name -> (L, ...) dict, or a module's parameters) as (S, L/S,
    ...) views."""
    named = (dict(layer_params.named_parameters()) if hasattr(layer_params, "named_parameters")
             else dict(layer_params))
    out = {}
    for name, a in named.items():
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        out[name] = a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return out


class _StageLayers:
    """A stage's slices of the layer stacks, in the shape ``qwen3_forward``
    reads (attributes, ``parameters``, ``named_parameters``)."""

    def __init__(self, stacks: Dict[str, torch.Tensor]):
        self._stacks = stacks
        self.__dict__.update(stacks)

    def named_parameters(self):
        return iter(self._stacks.items())

    def parameters(self):
        return iter(self._stacks.values())


class _Stage:
    """The stage's params for ``qwen3_forward``: its layers, and the mesh
    axes of the whole model (tensor parallelism inside the stage)."""

    def __init__(self, layers: _StageLayers, mesh_axes):
        self.layers = layers
        self._mesh_axes = mesh_axes


def _p2p(ops: List) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class _StageIn(torch.autograd.Function):
    """The head of a rank's chain: its inputs as they are, and a token
    (a 0-dim zero) the hand-overs pass on. Backward: the gradients of the
    inputs summed over the stage group, after the whole chain's."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return (xs[0].new_zeros(()),) + tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, g_token, *gs):
        out = []
        for g in gs:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None,) + tuple(out)


class _Exchange(torch.autograd.Function):
    """One tick's hand-over: send ``h`` to rank ``dst`` (if not None),
    receive a tensor of ``shape`` from rank ``src`` (if not None; else a
    0-dim zero), and pass ``token`` on. Backward: send the received
    tensor's gradient back to ``src`` and receive ``h``'s from ``dst``, in
    one batch."""

    @staticmethod
    def forward(ctx, h, token, dst, src, shape, dtype):
        ctx.dst, ctx.src, ctx.shape, ctx.dtype = dst, src, shape, dtype
        ops, out = [], None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, h.contiguous(), dst))
        if src is not None:
            out = torch.empty(shape, dtype=dtype, device=token.device)
            ops.append(dist.P2POp(dist.irecv, out, src))
        _p2p(ops)
        return (out if out is not None else token.new_zeros(())), token.view_as(token)

    @staticmethod
    def backward(ctx, g, g_token):
        ops, gh = [], None
        if ctx.src is not None:
            ops.append(dist.P2POp(dist.isend, g.contiguous(), ctx.src))
        if ctx.dst is not None:
            gh = torch.empty(ctx.shape, dtype=ctx.dtype, device=g.device)
            ops.append(dist.P2POp(dist.irecv, gh, ctx.dst))
        _p2p(ops)
        return gh, g_token, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's ``x`` on every rank of the stage group; backward:
    the last stage keeps its own gradient, the others pass none."""

    @staticmethod
    def forward(ctx, x, src, group, is_src, shape):
        ctx.is_src = is_src
        out = x.contiguous().clone() if is_src else torch.empty(shape, dtype=x.dtype,
                                                                device=x.device)
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else None), None, None, None, None


def pipelined_qwen3_forward(params, cfg: Qwen3Config, inputs_embeds: torch.Tensor, *,
                            positions: torch.Tensor, kv_valid: torch.Tensor, mesh,
                            n_micro: int, use_rope: bool = True,
                            remat: bool = False) -> torch.Tensor:
    """Ports ``mosstts_tpu.parallel.pipeline.pipelined_qwen3_forward``: the
    no-cache forward of ``params`` (a ``Qwen3Params``: the whole stack, or
    this stage's block of it) as the GPipe schedule over ``mesh``'s
    ``"stage"`` axis; ``n_micro`` microbatches must divide the batch.
    Returns the final-normed hidden states (B, T, D) on every rank."""
    if "stage" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no 'stage' axis")
    st = mesh_axis(mesh, "stage")
    S, sid = st.size, st.index
    B, T, D = inputs_embeds.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    M, Bm = n_micro, B // n_micro
    L = cfg.num_hidden_layers
    if L % S:
        raise ValueError(f"{L} layers not divisible by {S} stages")
    Ls = L // S
    named = dict(params.layers.named_parameters())
    whole = next(iter(named.values())).shape[0] == L  # the whole stack on every rank
    # the inputs whose gradients are summed over the stages: x, and a whole stack
    summed = {"x": inputs_embeds, **(named if whole else {})}
    summed = {k: v for k, v in summed.items() if torch.is_grad_enabled() and v.requires_grad}
    token, *outs = _StageIn.apply(st.group, inputs_embeds.new_zeros((), requires_grad=True),
                                  *summed.values()) if summed else (None,)
    summed = dict(zip(summed, outs[1:]))
    x = summed.get("x", inputs_embeds)
    if whole:
        stacks = {n: summed.get(n, p)[sid * Ls:(sid + 1) * Ls] for n, p in named.items()}
    else:  # this stage's block
        stacks = named
    stage = _Stage(_StageLayers(stacks), getattr(params, "_mesh_axes", {}))
    scfg = dataclasses.replace(cfg, num_hidden_layers=Ls)

    # the global rank of this rank's neighbour stages (same "model" coordinate)
    coord = [mesh.get_local_rank(d) for d in mesh.mesh_dim_names]

    def rank_at(s):
        c = list(coord)
        c[mesh.mesh_dim_names.index("stage")] = s
        return int(mesh.mesh[tuple(c)])

    x_mb = x.reshape(M, Bm, T, D)
    pos_mb = positions.reshape(M, Bm, T)
    kvv_mb = kv_valid.reshape(M, Bm, T)
    if token is None:  # nothing to differentiate
        token = inputs_embeds.new_zeros(())
    outs: List[Optional[torch.Tensor]] = [None] * M
    recv = None
    for t in range(M + S - 1):
        mb = t - sid
        h = None
        if 0 <= mb < M:
            h_in = x_mb[mb] if sid == 0 else recv
            h = qwen3_forward(stage, scfg, h_in, positions=pos_mb[mb], kv_valid=kvv_mb[mb],
                              use_rope=use_rope, remat=remat, final_norm=False)[0]
            if sid == S - 1:
                outs[mb] = h
        dst = rank_at(sid + 1) if h is not None and sid < S - 1 else None
        src = rank_at(sid - 1) if sid > 0 and 0 <= t - (sid - 1) < M else None
        recv = None
        if dst is not None or src is not None:
            got, token = _Exchange.apply(h if dst is not None else token, token, dst, src,
                                         (Bm, T, D), inputs_embeds.dtype)
            if src is not None:
                recv = got
    last = sid == S - 1
    hidden = torch.cat(outs, dim=0) if last else token
    hidden = _Broadcast.apply(hidden, rank_at(S - 1), st.group, last, (B, T, D))
    # the end of the chain joins the result (as a zero), so every rank's
    # backward runs the whole chain
    return rms_norm(hidden + token * 0, params.final_norm, cfg.rms_norm_eps)
