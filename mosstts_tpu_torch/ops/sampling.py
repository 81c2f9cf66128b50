"""Sampling ops: temperature / top-k / top-p / repetition penalty.

Ports ``mosstts_tpu/ops/sampling.py``. The filtering is the same
arithmetic, so filtered logits and greedy tokens equal the JAX package's.
The random draws cannot equal JAX's threefry bits: the port draws a
Gumbel-max categorical from one ``torch.Generator`` per batch row, seeded
from (seed, row), so row b's stream depends on its own seed only
(``sampling.py:29-55`` in the JAX package keeps one key per row for the
same reason). Top-k is exact ``torch.topk``, as the JAX CPU path is.

The step path makes no host-to-device copy, so a CUDA graph can capture
it (``engine/step_graph.py``): a control given as a Python number becomes
a device fill, and registered generators draw inside the graph.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _row_seed(seed: int, row: int) -> int:
    return int(np.random.SeedSequence((seed, row)).generate_state(1, np.uint64)[0])


def row_generators(seed: int, batch: int, device) -> list:
    """One generator per batch row on ``device``, seeded from (seed, row)."""
    return reseed_generators_([torch.Generator(device=device) for _ in range(batch)], seed)


def reseed_generators_(gens: Sequence[torch.Generator], seed: int,
                       first_row: int = 0) -> list:
    """Reseed the generators ``gens`` in place with ``row_generators``'
    (seed, row) seeds, so they draw what new ones would; ``gens[i]`` is row
    ``first_row + i`` (a data-parallel rank's block of the batch). A CUDA
    graph that registered them draws from the new seeds at its next replay."""
    for row, g in enumerate(gens, start=first_row):
        g.manual_seed(_row_seed(seed, row))
    return list(gens)


def _on(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A sampling control on ``device`` in ``dtype``: a tensor as it is (cast
    if needed), a Python number as a device fill (no host copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def align_rows(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.align_rows``: right-pad a per-row
    control (B,) with singleton dims to broadcast against (B, ..., V);
    scalars pass through."""
    if x.ndim == 0 or x.ndim >= ndim:
        return x
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.ndim))


def apply_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.apply_top_p``: keep the smallest
    prefix of descending-probability tokens whose mass reaches p (the
    crossing token included)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < align_rows(_on(p, torch.float32, logits.device), cum.ndim)
    thresh = sorted_logits.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


def apply_repetition_penalty_seen(logits: torch.Tensor, seen: torch.Tensor,
                                  penalty) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.apply_repetition_penalty_seen``."""
    penalty = align_rows(_on(penalty, logits.dtype, logits.device), logits.ndim)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def seen_mask_update(seen: torch.Tensor, tokens: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.seen_mask_update``: seen (..., V)
    bool; tokens (...) int; active (...) bool gating."""
    hot = F.one_hot(tokens.long(), seen.shape[-1]).bool()
    if active is not None:
        hot = hot & active[..., None]
    return seen | hot


def window_seen_mask(history: torch.Tensor, vocab: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.window_seen_mask``: history (..., W)
    int tokens -> (..., V) bool of the tokens present; ``valid`` (..., W)
    marks the real entries. Tokens outside [0, V) mark nothing, as JAX's
    ``one_hot`` gives them an all-false row: they (and invalid entries)
    scatter into a spare column V that is then dropped."""
    keep = (history >= 0) & (history < vocab)
    if valid is not None:
        keep = keep & valid
    idx = torch.where(keep, history.long(), vocab)
    seen = torch.zeros(history.shape[:-1] + (vocab + 1,), dtype=torch.bool,
                       device=history.device)
    return seen.scatter_(-1, idx, True)[..., :vocab]


def _categorical(gens: Sequence[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw along the last axis; row b's noise comes from
    ``gens[b]`` alone."""
    if len(gens) != logits.shape[0]:
        raise ValueError(f"{len(gens)} generators for {logits.shape[0]} rows")
    u = torch.stack([
        torch.rand(logits.shape[1:], generator=g, device=logits.device, dtype=torch.float32)
        for g in gens
    ])
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def topk_topp_filter(logits: torch.Tensor, top_k: int, top_p):
    """The filtered candidates ``sample_topk_topp`` draws from: the top-k
    values sorted descending (NEG_INF past the top-p prefix) and their
    vocabulary indices."""
    vals, idx = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)
    probs = torch.softmax(vals.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < align_rows(_on(top_p, torch.float32, logits.device), cum.ndim)
    return torch.where(keep, vals, NEG_INF), idx


def sample_topk_topp(
    gens: Sequence[torch.Generator],
    logits: torch.Tensor,  # (B, ..., V) temperature-scaled, penalty applied
    *,
    top_k: int,
    top_p,
    do_sample,
) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.sample_topk_topp``: with top_k > 0
    the nucleus pass runs inside the top-k subset. ``top_p`` and
    ``do_sample`` are scalars or (B,) per-row tensors; rows with
    ``do_sample`` False take the argmax (the first maximal index)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k and top_k > 0:
        vals, idx = topk_topp_filter(logits, top_k, top_p)
        choice = _categorical(gens, vals)
        sampled = torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)
    else:
        sampled = _categorical(gens, apply_top_p(logits, top_p)).to(torch.int32)
    do_sample = _on(do_sample, torch.bool, logits.device)
    return torch.where(align_rows(do_sample, sampled.ndim), sampled, greedy)


def find_last_equal(tokens: torch.Tensor, value: int) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.find_last_equal``: (B, T) -> (B,)
    index of the last occurrence of value, -1 if absent."""
    idx = torch.arange(tokens.shape[-1], device=tokens.device)
    return torch.where(tokens == value, idx, -1).amax(dim=-1).to(torch.int32)
