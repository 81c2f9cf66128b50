"""MossTTSRealtime: hierarchical text/audio interleaving for incremental
streaming synthesis.

Ports ``mosstts_tpu/models/realtime.py``: ``local_qwen_cfg``,
``init_realtime_params``, ``realtime_embed``, ``RealtimeSampling``/
``make_rt_sampling``, ``_rt_sample``, ``depth_generate_frame``,
``RealtimeState``, ``realtime_prefill_step`` (a scalar cache cursor, or
(B,) per-row cursors for one row at a time), ``realtime_decode_step``,
``init_realtime_state``, ``init_realtime_srv_state`` and the training loss
``realtime_loss``.

A frame is one backbone token step, then the depth transformer (the Qwen3
block over a fresh cache of ``rvq`` slots) decodes the frame's ``rvq``
codebooks one after another, each with the windowed repetition penalty and
top-k/top-p sampling. JAX runs the depth loop as a ``lax.scan``; here it is
a Python loop, which a CUDA graph of the frame (``engine/step_graph.py``)
holds unrolled. On the card the backbone step and every depth step go
through the decode-attention kernel, a prefill through flash attention, and
int8 weights through the W8A16 kernel; int8 local heads run one head's
(D, Va) slice per depth step, so only that slice's bytes are read.

The state holds one threefry key per row, (B, 2) int64, where JAX holds
one key for the batch; each frame splits a row's key as JAX splits its one
(``rng, rng_f = split(rng)``, then ``split(rng_f, rvq)`` for the depth
steps), so a row's draws depend on its own key only and a batch of one
draws JAX's bits. ``kv_valid`` and ``history`` are written in place;
the other fields a step changes come back as new tensors, as in JAX. A
scalar ``cur_len``/``hist_len`` is a 0-dim device tensor, so a step needs
no host value and a CUDA graph can capture it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import Qwen3Config, RealtimeConfig, RealtimeLocalConfig
from ..nn.qwen3 import Qwen3Params, empty_param, fill_qwen3_params_, init_kv_cache, qwen3_forward
from ..ops.basic import head_logits
from ..ops.kernels import threefry
from ..ops.sampling import (_categorical, align_rows, apply_repetition_penalty_seen,
                            split_keys, topk_topp_filter, window_seen_mask)
from ..ops.collectives import axis_of, reduce
from .delay import ce_sums

REP_WINDOW = 50  # reference default repetition_window (streaming:136)


def local_qwen_cfg(lc: RealtimeLocalConfig) -> Qwen3Config:
    """Ports ``mosstts_tpu.models.realtime.local_qwen_cfg``."""
    return Qwen3Config(
        vocab_size=1,
        hidden_size=lc.hidden_size,
        intermediate_size=lc.intermediate_size,
        num_hidden_layers=lc.num_hidden_layers,
        num_attention_heads=lc.num_attention_heads,
        num_key_value_heads=lc.num_key_value_heads,
        head_dim=lc.head_dim,
        rms_norm_eps=lc.rms_norm_eps,
        rope_theta=lc.rope_theta,
        max_position_embeddings=lc.max_position_embeddings,
    )


class RealtimeParams(nn.Module):
    """Ports the ``init_realtime_params`` pytree: ``text_emb`` (V, D),
    ``audio_emb`` (rvq, Va, D), ``backbone`` and ``local`` (Qwen3 stacks
    without embeddings), ``local_emb`` (rvq - 1, Va, Dl) and
    ``local_heads`` (rvq, Dl, Va)."""

    def __init__(self, cfg: RealtimeConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        lc, loc = cfg.language_config, cfg.local_config
        self.text_emb = empty_param((lc.vocab_size, lc.hidden_size), dtype, device)
        self.audio_emb = empty_param((cfg.rvq, cfg.audio_vocab_size, lc.hidden_size), dtype,
                                     device)
        self.backbone = Qwen3Params(lc, dtype=dtype, device=device, with_embed=False)
        self.local = Qwen3Params(local_qwen_cfg(loc), dtype=dtype, device=device,
                                 with_embed=False)
        self.local_emb = empty_param((cfg.rvq - 1, loc.audio_vocab_size, loc.hidden_size),
                                     dtype, device)
        self.local_heads = empty_param((cfg.rvq, loc.hidden_size, loc.audio_vocab_size),
                                       dtype, device)


@torch.no_grad()
def init_realtime_params(cfg: RealtimeConfig, *, generator: torch.Generator,
                         dtype=torch.float32, device=None) -> RealtimeParams:
    """Ports ``mosstts_tpu.models.realtime.init_realtime_params``, drawing
    on ``device`` with ``generator``. The draws differ from JAX's; parity
    tests load JAX weights through ``utils.convert``."""
    params = RealtimeParams(cfg, dtype=dtype, device=device)
    fill_qwen3_params_(params.backbone, generator)
    fill_qwen3_params_(params.local, generator)
    for p in (params.text_emb, params.audio_emb, params.local_emb, params.local_heads):
        p.normal_(0.0, cfg.initializer_range, generator=generator)
    return params


def realtime_embed(params: RealtimeParams, cfg: RealtimeConfig,
                   ids: torch.Tensor) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.realtime.realtime_embed``: ids (B, T,
    1+rvq) -> summed embeddings (B, T, D)."""
    Va = cfg.audio_vocab_size
    emb = params.text_emb[ids[..., 0].long()]
    flat = params.audio_emb.reshape(cfg.rvq * Va, -1)
    offs = torch.arange(cfg.rvq, device=ids.device) * Va
    audio = flat[ids[..., 1:].long().clamp(0, Va - 1) + offs]
    return emb + audio.to(emb.dtype).sum(dim=-2)


def realtime_loss(
    params: RealtimeParams, cfg: RealtimeConfig,
    ids: torch.Tensor,  # (B, T, 1+rvq)
    attention_mask: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T, 1+rvq), -100 ignore; audio channels trained
    remat: bool = False,
):
    """Ports ``mosstts_tpu.models.realtime.realtime_loss`` (reference
    modeling_mossttsrealtime.py:149-171): the backbone runs over the grid;
    the depth transformer is teacher-forced per frame with the backbone's
    hidden state at the PREVIOUS position in slot 0 (position 0 takes its
    own) and the label codebooks 0..rvq-2 in slots 1..rvq-1 (a -100 label
    embeds the pad token); the loss is the cross-entropy over the rvq
    codebooks' valid labels at the frames whose audio labels are not all
    -100 (the fixed (B, T) lattice, masked, as in JAX). Returns (loss,
    {"trained_frames"}). On a mesh (``parallel/mesh.py``) the sum and
    count are summed over ``"data"``; the family's spec table admits no
    ``"model"`` axis of 2 or more (its rvq and rvq - 1 codebook tables
    cannot both divide), in JAX as here."""
    dp = axis_of(params, "data")
    lc, loc = cfg.language_config, cfg.local_config
    lq = local_qwen_cfg(loc)
    B, T, C = ids.shape
    R, Va = cfg.rvq, loc.audio_vocab_size
    dev = ids.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    hidden, _ = qwen3_forward(params.backbone, lc, realtime_embed(params, cfg, ids),
                              positions=positions, kv_valid=attention_mask.bool(), remat=remat)

    audio_labels = labels[..., 1:]  # (B, T, R)
    train_mask = ~(audio_labels == -100).all(dim=-1)  # (B, T)
    prev_hidden = torch.cat([hidden[:, :1], hidden[:, :-1]], dim=1)
    safe = torch.where(audio_labels == -100, loc.audio_pad_token, audio_labels)
    safe = safe.clamp(0, Va - 1).long()
    emb = params.local_emb.unbind(0)
    chans = [prev_hidden] + [emb[i][safe[..., i]] for i in range(R - 1)]
    h, _ = qwen3_forward(
        params.local, lq, torch.stack(chans, dim=2).reshape(B * T, R, -1),
        positions=torch.arange(R, dtype=torch.int32, device=dev)[None].expand(B * T, R),
        kv_valid=torch.ones((B * T, R), dtype=torch.bool, device=dev), remat=remat)
    logits = torch.einsum("brd,rdv->brv", h.float(), params.local_heads.float())
    valid = (audio_labels != -100) & train_mask[..., None]
    labels_masked = torch.where(valid, safe, -100)
    total, count = ce_sums(logits.reshape(1, B * T * R, Va), labels_masked.reshape(1, -1))
    return (reduce(total[0], dp) / reduce(count[0], dp).clamp(min=1),
            {"trained_frames": train_mask.sum()})


class RealtimeSampling(NamedTuple):
    """Ports ``mosstts_tpu.models.realtime.RealtimeSampling``: each knob a
    0-dim tensor, or (B,) for per-row values."""

    temperature: torch.Tensor
    top_p: torch.Tensor
    repetition_penalty: torch.Tensor
    do_sample: torch.Tensor
    use_penalty: torch.Tensor


def make_rt_sampling(temperature=0.8, top_p=0.6, repetition_penalty=1.1, do_sample=True, *,
                     device=None) -> RealtimeSampling:
    """Ports ``mosstts_tpu.models.realtime.make_rt_sampling``: every knob
    also takes a (B,) array, one value per row; temperature 0 means
    greedy."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    rp = 1.0 if repetition_penalty is None else repetition_penalty
    t, rp = f32(temperature), f32(rp)
    return RealtimeSampling(
        temperature=t, top_p=f32(top_p), repetition_penalty=rp,
        do_sample=torch.as_tensor(do_sample, dtype=torch.bool, device=device) & (t != 0.0),
        use_penalty=rp != 1.0)


def _rt_sample(keys, logits: torch.Tensor, s: RealtimeSampling, top_k: int) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.realtime._rt_sample``: the reference order
    (streaming:338-356), the penalty on the raw logits (done by the
    caller), then temperature, top-k, top-p (``cum - probs < p``) and the
    draw; a greedy row takes the argmax of the penalised logits."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / align_rows(torch.clamp(s.temperature, min=1e-6), logits.ndim)
    V = logits.shape[-1]
    k = min(top_k, V) if top_k and top_k > 0 else V
    vals, idx = topk_topp_filter(scaled, k, s.top_p)
    choice = _categorical(keys, vals)
    sampled = torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)
    return torch.where(align_rows(s.do_sample, sampled.ndim), sampled, greedy)


def _history_window(history: torch.Tensor, hist_len: torch.Tensor, R: int):
    """The last ``REP_WINDOW`` frames before ``hist_len`` (a 0-dim or (B,)
    cursor): (B, R, W) tokens and their validity."""
    B, H = history.shape[:2]
    W = min(REP_WINDOW, H)
    hl = hist_len.expand(B) if hist_len.ndim == 0 else hist_len
    start = torch.clamp(hl - W, 0, max(H - W, 0))  # (B,)
    idx = start[:, None] + torch.arange(W, dtype=torch.int32, device=history.device)[None]
    win = torch.gather(history, 1, idx.long()[:, :, None].expand(B, W, R))
    valid = (idx < hl[:, None])[:, None, :].expand(B, R, W)
    return win.transpose(1, 2), valid


def depth_generate_frame(
    params: RealtimeParams, cfg: RealtimeConfig, keys: torch.Tensor,  # (B, 2)
    hidden: torch.Tensor,  # (B, D) backbone last hidden
    history: torch.Tensor,  # (B, Hlen, rvq) generated frames
    hist_len: torch.Tensor,  # frames generated so far: 0-dim, or (B,) per row
    sampling: RealtimeSampling,
    *, top_k: int = 30,
) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.realtime.depth_generate_frame``: the
    ``rvq``-codebook depth loop -> (B, rvq) int32 frame (reference
    generate_local_transformer, streaming:301-357). ``keys`` holds one key
    per row, split into the ``rvq`` depth steps' keys (JAX's
    ``split(rng, R)``, row by row)."""
    loc = cfg.local_config
    lq = local_qwen_cfg(loc)
    B = hidden.shape[0]
    R = cfg.rvq
    Va = loc.audio_vocab_size
    dev = hidden.device

    cache = init_kv_cache(lq, B, R, dtype=hidden.dtype, device=dev)
    slots = torch.arange(R, device=dev)[None]
    win, valid = _history_window(history, hist_len, R)
    seen = window_seen_mask(win, Va, valid=valid)  # (B, rvq, Va)
    rp = torch.where(sampling.use_penalty, sampling.repetition_penalty, 1.0)

    rngs = threefry.split(keys, R)  # (B, R, 2)
    x = hidden
    toks = []
    for i in range(R):
        h, _ = qwen3_forward(
            params.local, lq, x[:, None, :],
            positions=torch.full((B, 1), i, dtype=torch.int32, device=dev),
            kv_valid=(slots <= i).expand(B, R), cache=cache, cache_offset=i)
        logits = head_logits(h[:, 0], params.local_heads, i)
        logits = apply_repetition_penalty_seen(logits, seen[:, i], rp)
        tok = _rt_sample(rngs[:, i], logits, sampling, top_k)
        toks.append(tok)
        if i + 1 < R:  # the next position embeds this token with table i
            x = params.local_emb[i][tok.long().clamp(0, Va - 1)].to(x.dtype)
    return torch.stack(toks, dim=1)


class RealtimeState(NamedTuple):
    """Ports ``mosstts_tpu.models.realtime.RealtimeState``: the carried
    decode state of one conversation per row (multi-turn KV reuse is the
    cache carried over plus the mask concatenated); ``rng`` one threefry
    key per row."""

    cache: Any  # KVCache
    kv_valid: torch.Tensor  # (B, S) bool
    cur_len: torch.Tensor  # int32 cache slots used: 0-dim, or (B,) per row
    last_audio: torch.Tensor  # (B, rvq) int32
    is_stopping: torch.Tensor  # (B,) bool
    history: torch.Tensor  # (B, H, rvq) int32 generated frames (rep-penalty window)
    hist_len: torch.Tensor  # int32: 0-dim, or (B,) per row
    rng: torch.Tensor  # (B, 2) int64 per-row threefry keys


def realtime_prefill_step(
    params: RealtimeParams, cfg: RealtimeConfig, state: RealtimeState,
    input_ids: torch.Tensor,  # (B, T, 1+rvq) new rows (left-padded)
    row_valid: torch.Tensor,  # (B, T) bool
    sampling: RealtimeSampling,
    *, top_k: int = 30, attend_len: Optional[int] = None,
) -> Tuple[RealtimeState, torch.Tensor]:
    """Ports ``mosstts_tpu.models.realtime.realtime_prefill_step``: feed T
    new rows at the cache cursor, then decode the first frame. Returns
    (state, frame (B, rvq)); ``kv_valid``, ``history`` and the cache are
    written in place.

    (B,) per-row cursors (the continuous-batching server) take T == 1
    only; admissions prefill a batch-k group through the scalar path and
    are spliced into the slots."""
    B, T, _ = input_ids.shape
    dev = input_ids.device
    per_row = state.cur_len.ndim == 1
    S = state.kv_valid.shape[1]
    H = state.history.shape[1]
    rows = torch.arange(B, device=dev)
    kv_valid = state.kv_valid
    if per_row:
        if T != 1:
            raise ValueError("per-row-cursor states decode one row at a time")
        pos = state.cur_len
        positions = pos[:, None]
        kv_valid[rows, pos.clamp(0, S - 1).long()] = row_valid[:, 0]
        cache_offset = pos
    else:
        offset = state.cur_len
        positions = (offset + torch.arange(T, dtype=torch.int32, device=dev))[None].expand(B, T)
        # dynamic_update_slice: the start clamps so the T rows fit
        start = offset.clamp(0, S - T).long()
        kv_valid.index_copy_(1, start + torch.arange(T, device=dev), row_valid)
        # one-token steps write through the per-row scatter, as JAX does
        cache_offset = offset.expand(B) if T == 1 else offset
    embeds = realtime_embed(params, cfg, input_ids)
    hidden, cache = qwen3_forward(
        params.backbone, cfg.language_config, embeds, positions=positions, kv_valid=kv_valid,
        cache=state.cache, cache_offset=cache_offset, attend_len=attend_len)
    rng, rng_f = split_keys(state.rng, 2)
    frame = depth_generate_frame(params, cfg, rng_f, hidden[:, -1], state.history,
                                 state.hist_len, sampling, top_k=top_k)
    if per_row:
        state.history[rows, state.hist_len.clamp(0, H - 1).long()] = frame
        # stopped and idle rows freeze their cache cursor (their masked
        # writes land on the same never-valid slot instead of using cache)
        new_cur = pos + row_valid[:, 0].to(torch.int32)
    else:
        state.history.index_copy_(1, state.hist_len.clamp(0, H - 1).long().reshape(1),
                                  frame[:, None, :])
        new_cur = state.cur_len + T
    is_stopping = state.is_stopping | (frame[:, 0] == cfg.audio_eos_token)
    return (state._replace(cache=cache, kv_valid=kv_valid, cur_len=new_cur, last_audio=frame,
                           is_stopping=is_stopping, hist_len=state.hist_len + 1, rng=rng),
            frame)


def realtime_decode_step(
    params: RealtimeParams, cfg: RealtimeConfig, state: RealtimeState,
    text_token: torch.Tensor,  # (B,)
    sampling: RealtimeSampling,
    *, top_k: int = 30, attend_len: Optional[int] = None,
) -> Tuple[RealtimeState, torch.Tensor]:
    """Ports ``mosstts_tpu.models.realtime.realtime_decode_step``: one
    frame; the input row is [text_token | previous audio frame], valid
    unless the row has stopped (reference streaming:241-242). A stopped row
    keeps its last frame."""
    step_ids = torch.cat([text_token[:, None, None].to(state.last_audio.dtype),
                          state.last_audio[:, None, :]], dim=2)
    row_valid = (~state.is_stopping)[:, None]
    new_state, frame = realtime_prefill_step(params, cfg, state, step_ids, row_valid, sampling,
                                             top_k=top_k, attend_len=attend_len)
    frame = torch.where(state.is_stopping[:, None], state.last_audio, frame)
    return new_state._replace(
        last_audio=frame,
        is_stopping=state.is_stopping | (frame[:, 0] == cfg.audio_eos_token)), frame


def init_realtime_state(cfg: RealtimeConfig, batch: int, cache_len: int, max_frames: int,
                        rng: torch.Tensor, *, dtype=torch.bfloat16,
                        device=None) -> RealtimeState:
    """Ports ``mosstts_tpu.models.realtime.init_realtime_state``: ``rng``
    (batch, 2), one key per row."""
    if tuple(rng.shape) != (batch, 2):
        raise ValueError(f"need one key per row: {tuple(rng.shape)} for batch {batch}")
    return RealtimeState(
        cache=init_kv_cache(cfg.language_config, batch, cache_len, dtype=dtype, device=device),
        kv_valid=torch.zeros((batch, cache_len), dtype=torch.bool, device=device),
        cur_len=torch.zeros((), dtype=torch.int32, device=device),
        last_audio=torch.full((batch, cfg.rvq), cfg.audio_pad_token, dtype=torch.int32,
                              device=device),
        is_stopping=torch.zeros((batch,), dtype=torch.bool, device=device),
        history=torch.zeros((batch, max_frames, cfg.rvq), dtype=torch.int32, device=device),
        hist_len=torch.zeros((), dtype=torch.int32, device=device),
        rng=rng.to(device=device, dtype=torch.int64).clone())


def init_realtime_srv_state(cfg: RealtimeConfig, slots: int, cache_len: int, max_frames: int,
                            rng: torch.Tensor, *, dtype=torch.bfloat16,
                            device=None) -> RealtimeState:
    """Ports ``mosstts_tpu.models.realtime.init_realtime_srv_state``: (slots,)
    ``cur_len``/``hist_len`` cursors, every slot idle (``is_stopping``) until
    a request is spliced in."""
    st = init_realtime_state(cfg, slots, cache_len, max_frames, rng, dtype=dtype,
                             device=device)
    return st._replace(cur_len=torch.zeros((slots,), dtype=torch.int32, device=device),
                       hist_len=torch.zeros((slots,), dtype=torch.int32, device=device),
                       is_stopping=torch.ones((slots,), dtype=torch.bool, device=device))
