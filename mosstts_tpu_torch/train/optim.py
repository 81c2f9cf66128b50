"""The trainers' optimizers, equal to the optax calls of the JAX package
update for update.

Ports what ``mosstts_tpu/train/trainer.py:_optimizer`` and
``mosstts_tpu/codec/train.py:make_codec_optimizer`` build with optax, as
plain functions on tensors and two optimizer objects that hold the state:

* ``warmup_cosine_decay``: ``optax.warmup_cosine_decay_schedule`` (a linear
  warmup from ``init`` to ``peak``, then a cosine decay to ``end``), in
  float32 as optax computes it under ``jit``. The first update reads count
  0, so its learning rate is ``init`` (0 in both trainers).
* ``global_norm`` and ``clip_by_global_norm``: ``g * max / norm`` where
  ``norm >= max``, the gradients as they are below (no ``+ 1e-6`` in the
  divisor, unlike ``torch.nn.utils.clip_grad_norm_``).
* ``AdamW``: clip, then ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, bias correction at count + 1, the decoupled decay
  ``wd * p`` added to every leaf before the learning rate scales the sum;
  moments in the parameter's dtype).
* ``Adafactor``: clip, then ``optax.adafactor(lr,
  multiply_by_parameter_scale=False, clipping_threshold=None,
  momentum=None, weight_decay_rate=wd)``: second moments factored over the
  two largest dims where the smaller of them is >= 128 (one full moment
  otherwise), decay ``1 - (count + 1) ** -0.8``, eps 1e-30 added to the
  squared gradient; the decay ``wd * p`` is added after the learning rate
  scales the update, so it is not multiplied by the learning rate.

The optimizers update the parameters in place under ``torch.no_grad``. The
scalars of a step (learning rate, bias corrections, decay rate) are
float32 tensors on the parameters' device, so the card divides by them as
the CPU does (a division by a Python number is a multiply by its
reciprocal there).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

Schedule = Callable[[int], float]
_F = np.float32


def warmup_cosine_decay(step: int, init: float, peak: float, warmup: int, decay_steps: int,
                        end: float) -> float:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup,
    decay_steps, end)`` at ``step`` (an update count from 0)."""
    if step < warmup:  # linear from init to peak over the warmup
        frac = _F(1) - _F(max(step, 0)) / _F(warmup)
        return float((_F(init) - _F(peak)) * frac + _F(peak))
    span = decay_steps - warmup
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup {warmup}")
    alpha = 0.0 if peak == 0.0 else end / peak
    count = _F(min(step - warmup, span))
    cosine = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * count / _F(span), dtype=_F))
    return float(_F(peak) * (_F(1.0 - alpha) * cosine + _F(alpha)))


def warmup_cosine(peak: float, warmup: int, total: int) -> Schedule:
    """Both trainers' schedule: from 0 over ``warmup`` steps to ``peak``,
    then down to ``peak / 20`` at ``max(total, warmup + 1)``."""
    decay = max(total, warmup + 1)
    return lambda step: warmup_cosine_decay(step, 0.0, peak, warmup, decay, peak * 0.05)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of every leaf's
    sum of squares (a 0-dim float32 tensor)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def sharded_global_norm(grads: Dict[str, torch.Tensor],
                        replicas: Dict[str, int]) -> torch.Tensor:
    """``global_norm`` of a model sharded over the world's ranks
    (``parallel/mesh.py``): each rank's sums of squares, each divided by the
    number of ranks holding the same block (``replicas``), summed over the
    world, so a split parameter counts every block once and a replicated
    one once."""
    sq = sum((g.float() * g.float()).sum() / replicas[n] for n, g in grads.items())
    dist.all_reduce(sq)
    return torch.sqrt(sq)


def _clip(g: torch.Tensor, norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)


def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        max_norm: float) -> Dict[str, torch.Tensor]:
    """``optax.clip_by_global_norm(max_norm)``: every leaf times
    ``max_norm / norm`` where ``norm >= max_norm``, as it is below."""
    norm = global_norm(grads.values())
    return {n: _clip(g, norm, max_norm) for n, g in grads.items()}


def value_and_grad(params: nn.Module, loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over every parameter
    of ``params``: (loss, aux, name -> gradient), the loss and aux detached.
    Parameters that do not require gradients (``init_*_params`` makes them
    so) require them for the call only; a parameter the loss does not reach
    gets a zero gradient, as in JAX."""
    named = dict(params.named_parameters())
    frozen = [p for p in named.values() if not p.requires_grad]
    for p in frozen:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, aux = loss_fn(params)
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        for p in frozen:
            p.requires_grad_(False)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class _Optimizer:
    """Clip, then the family's update, over a name -> parameter dict (a
    module's ``named_parameters()``). ``count`` is optax's update count."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: Schedule, *, weight_decay: float,
                 clip_norm: float = 1.0):
        self.params = dict(params)
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.clip_norm = float(clip_norm)
        self.count = 0
        # name -> ranks holding the same block, for a sharded model (None: the
        # whole model is here)
        self.replicas: Optional[Dict[str, int]] = None

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (name -> gradient); returns the global
        norm of the gradients before clipping."""
        if set(grads) != set(self.params):
            raise KeyError(f"gradients and parameters differ: "
                           f"{sorted(set(grads) ^ set(self.params))}")
        norm = (global_norm(grads.values()) if self.replicas is None
                else sharded_global_norm(grads, self.replicas))
        # one leaf at a time: no clipped copy of all the gradients
        self._update(lambda name: _clip(grads[name], norm, self.clip_norm))
        self.count += 1
        return norm

    def _update(self, grad: Callable[[str], torch.Tensor]) -> None:
        """Update every parameter in place; ``grad(name)`` is its clipped
        gradient."""
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"count": self.count, **{k: dict(getattr(self, k)) for k in self.STATE}}

    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` in place: every moment keeps its tensor."""
        self.count = int(state["count"])
        for key in self.STATE:
            mine = getattr(self, key)
            if set(state[key]) != set(mine):
                raise KeyError(f"optimizer state {key!r} names differ")
            for name, t in state[key].items():
                mine[name].copy_(t)


class AdamW(_Optimizer):
    """Clip, then ``optax.adamw(lr, b1, b2, eps, weight_decay=wd)``."""

    STATE = ("mu", "nu")

    def __init__(self, params, lr: Schedule, *, weight_decay: float, clip_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr, weight_decay=weight_decay, clip_norm=clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    def _update(self, grad):
        t = self.count + 1
        some = next(iter(self.params.values()))
        bc1 = _scalar(_F(1) - _F(self.b1) ** _F(t), some)
        bc2 = _scalar(_F(1) - _F(self.b2) ** _F(t), some)
        neg_lr = _scalar(-_F(self.lr(self.count)), some)
        for name, p in self.params.items():
            g = grad(name)
            mu = self.mu[name].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[name].mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1.to(p.dtype)) / (torch.sqrt(nu / bc2.to(p.dtype)) + self.eps)
            u = u + self.weight_decay * p
            p.add_(neg_lr.to(p.dtype) * u)


def factored_dims(shape: Tuple[int, ...], min_dim: int = 128) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (second largest, largest) dim of a leaf
    whose two largest dims are both >= ``min_dim`` (ties keep the earlier
    dim second), else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


class Adafactor(_Optimizer):
    """Clip, then ``optax.adafactor(lr, multiply_by_parameter_scale=False,
    clipping_threshold=None, momentum=None, weight_decay_rate=wd)``. A
    factored leaf keeps ``v_row`` (the shape without its largest dim) and
    ``v_col`` (without the second largest), an unfactored one ``v``."""

    STATE = ("v_row", "v_col", "v")

    def __init__(self, params, lr: Schedule, *, weight_decay: float, clip_norm: float = 1.0,
                 decay_rate: float = 0.8, eps: float = 1e-30, min_dim_size_to_factor: int = 128):
        super().__init__(params, lr, weight_decay=weight_decay, clip_norm=clip_norm)
        self.decay_rate, self.eps, self.min_dim = decay_rate, eps, min_dim_size_to_factor
        self.v_row, self.v_col, self.v = {}, {}, {}
        for n, p in self.params.items():
            dims = factored_dims(tuple(p.shape), self.min_dim)
            if dims is None:
                self.v[n] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                self.v_row[n] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                self.v_col[n] = p.new_zeros(shape[:d1] + shape[d1 + 1:])

    def _update(self, grad):
        some = next(iter(self.params.values()))
        decay = _F(1) - (_F(self.count) + _F(1)) ** _F(-self.decay_rate)
        rho, keep = _scalar(_F(1) - decay, some), _scalar(decay, some)
        lr = _scalar(self.lr(self.count), some)
        for name, p in self.params.items():
            g = grad(name)
            sq = g * g + self.eps
            if name in self.v:
                v = self.v[name].mul_(keep).add_(rho * sq)
                u = g * v.pow(-0.5)
            else:
                d1, d0 = factored_dims(tuple(p.shape), self.min_dim)
                row = self.v_row[name].mul_(keep).add_(rho * sq.mean(dim=d0))
                col = self.v_col[name].mul_(keep).add_(rho * sq.mean(dim=d1))
                r1 = d1 - 1 if d1 > d0 else d1
                row_factor = (row / row.mean(dim=r1, keepdim=True)).pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col.pow(-0.5).unsqueeze(d1)
            u = lr.to(p.dtype) * u + self.weight_decay * p
            p.add_(-u)
