"""Sampling ops: temperature / top-k / top-p / repetition penalty, and
JAX's threefry2x32 random bits.

Ports ``mosstts_tpu/ops/sampling.py``. The filtering is the same
arithmetic, so filtered logits and greedy tokens equal the JAX package's.
Top-k is exact ``torch.topk``, as the JAX CPU path is.

The random draws are JAX's own. A state holds one threefry key per row,
(B, 2) ``int64`` tensors of JAX's two uint32 key words, and each step
splits them as JAX does (``split_keys``); the draw is JAX's Gumbel-max
``categorical``, ``argmax(logits - log(-log(u)))`` with ``u`` JAX's
``uniform(minval=tiny)`` of the row's threefry bits. ``prng_key``,
``split``, ``random_bits``, ``uniform`` and ``categorical_plain`` below
reproduce ``jax.random`` (threefry2x32 with ``jax_threefry_partitionable``,
JAX's default) bit for bit on uint32 values held in int64 tensors. On the
card the split and the fused categorical are one kernel each
(``ops/kernels/threefry.py``); the functions here are their plain versions.

Keys live in the state, not in ``torch.Generator`` objects, so a CUDA
graph replayed many times inside one launch (``engine/step_graph.py``'s
device loops) draws each iteration from the keys that iteration carries,
and an admission on the device hands a request its key with a copy. The
step path makes no host-to-device copy: a control given as a Python
number becomes a device fill.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import threefry as _threefry

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def prng_key(seed: int) -> torch.Tensor:
    """JAX's ``PRNGKey(seed)`` (64-bit values off): the (2,) key ``(0,
    seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash of the counter words ``(x0, x1)`` under the
    key ``(k0, k1)``: uint32 values in int64 tensors (broadcast), 20
    rounds."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & _M32, (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _counter_bits(keys: torch.Tensor, n: int):
    """threefry of the counters 0..n-1 under each key of ``keys`` (..., 2):
    two (..., n) word tensors (JAX's partitionable counters: the flat
    index's high word, 0 here, and its low word)."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(cnt), cnt)


def split(keys: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``random.split`` of each key of ``keys`` (..., 2) into ``n``:
    (..., n, 2). The plain version of ``ops.kernels.threefry.split``."""
    b0, b1 = _counter_bits(keys.long(), n)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's 32-bit ``random_bits(key, 32, shape)``: uint32 values in an
    int64 tensor."""
    b0, b1 = _counter_bits(key.long(), int(np.prod(shape, dtype=np.int64)))
    return (b0 ^ b1).reshape(tuple(shape))


def _uniform_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's ``uniform(minval=tiny, maxval=1)`` of 32-bit words: the top 23
    bits as a mantissa of [1, 2), minus 1, then ``* (1 - tiny) + tiny``
    (``1 - tiny`` is 1 in float32) floored at tiny."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + TINY, TINY)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's ``random.uniform(key, shape, minval=tiny, maxval=1.0)`` in
    float32, the uniform its Gumbel draw takes."""
    return _uniform_bits(random_bits(key, shape))


def categorical_plain(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """JAX's ``random.categorical`` of each row of ``logits`` (B, ..., V)
    with its own key ``keys[b]`` (JAX's ``vmap`` over per-row keys): the
    Gumbel noise of row b is drawn over the row's whole shape (the flat
    index counts the counters), added to the float32 logits, and the
    argmax (the first maximal index) taken over the last axis -> (B, ...)
    int64. The plain version of ``ops.kernels.threefry.categorical``."""
    B = logits.shape[0]
    n = logits[0].numel()
    b0, b1 = _counter_bits(keys.long().reshape(B, 2), n)
    g = -torch.log(-torch.log(_uniform_bits(b0 ^ b1)))
    return torch.argmax(g.reshape(logits.shape) + logits.float(), dim=-1)


def row_keys(seed: int, batch: int) -> torch.Tensor:
    """One key per row of a batch, as JAX's prefill makes them from one
    seed: ``split(PRNGKey(seed), batch)``, (batch, 2) int64 on the CPU."""
    return split(prng_key(seed)[None], batch)[0]


def split_keys(rng: torch.Tensor, n: int):
    """Ports ``mosstts_tpu.ops.sampling.split_keys`` for (B, 2) per-row
    keys: ``n`` (B, 2) keys, each row split from its own (one kernel on
    the card)."""
    ks = _threefry.split(rng, n)
    return tuple(ks[:, i] for i in range(n))


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


def _categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """JAX's per-row ``categorical`` along the last axis: row b's noise
    comes from ``keys[b]`` alone (the fused kernel on the card)."""
    if keys.shape[0] != logits.shape[0]:
        raise ValueError(f"{keys.shape[0]} keys for {logits.shape[0]} rows")
    return _threefry.categorical(keys, logits)


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
    keys: torch.Tensor,  # (B, 2) per-row threefry keys
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
        choice = _categorical(keys, vals)
        sampled = torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)
    else:
        sampled = _categorical(keys, apply_top_p(logits, top_p)).to(torch.int32)
    do_sample = _on(do_sample, torch.bool, logits.device)
    return torch.where(align_rows(do_sample, sampled.ndim), sampled, greedy)


def find_last_equal(tokens: torch.Tensor, value: int) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.sampling.find_last_equal``: (B, T) -> (B,)
    index of the last occurrence of value, -1 if absent."""
    idx = torch.arange(tokens.shape[-1], device=tokens.device)
    return torch.where(tokens == value, idx, -1).amax(dim=-1).to(torch.int32)
