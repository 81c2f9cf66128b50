"""MossTTSLocal: a global temporal transformer plus a per-frame depth
("local") transformer over time-synchronous RVQ blocks.

Ports ``mosstts_tpu/models/local.py``: ``LocalParams`` (the
``init_local_params`` tree's names), ``init_local_params``,
``local_embed``, ``LocalSampling``/``make_local_sampling``,
``_sample_channel``, ``LocalGenState``, ``_depth_decode``,
``local_frame_step`` (a scalar cursor, or (B,) per-row cursors for the
continuous-batching server), ``local_prefill_split`` and the training loss
``local_loss``.

A frame is one backbone token step, then the depth transformer (the Qwen3
block without rotary embeddings) decodes the frame's text channel and its
``min(n_vq, n_vq_infer)`` audio channels one after another, each a single
cached step, each sampled with its own controls (temperature, then top-k
inside a static ``TOPK_WIDTH`` subset, then top-p; the repetition penalty
on sampled audio channels only). JAX runs the audio channels as a
``lax.scan``; here the loop is unrolled in Python, which a CUDA graph of
the frame (``engine/step_graph.LocalSteps``) holds as it is. The depth
transformer's KV cache (``LocalGenState.depth``, ``channels`` slots) is
part of the state and zeroed at each frame, where JAX makes a new one.
Each stacked adapter, norm and head is taken per channel with
``take_weight``; an int8 audio head reads one (D, Va) slice per channel
through the W8A16 kernel. On the card the backbone step and every depth
step go through the decode-attention kernel, a prefill through flash
attention, and int8 weights through W8A16.

The state holds one threefry key per row, (B, 2) int64, where JAX holds
one key for the batch; each frame splits a row's key as JAX splits its one
(``rng, rng_depth = split(rng)``, then ``split(rng_depth, C_run)`` for
the channels), so a batch of one draws JAX's bits.
The cache, ``kv_valid``, ``seen_text``, ``seen_audio``, ``out`` and
``depth`` are written in place; ``cur_ids``, ``pos``, ``step`` and
``unfinished`` come back as new tensors, as in JAX. A scalar ``pos`` and
``step`` are 0-dim device tensors, so a frame needs no host value.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from ..core.config import LocalConfig
from ..nn.qwen3 import (KVCache, Qwen3Params, empty_param, fill_qwen3_params_, init_kv_cache,
                        qwen3_forward)
from ..ops.basic import dense, head_logits, rms_norm, swiglu
from ..ops.quant import take_weight
from ..ops.kernels import threefry
from ..ops.sampling import (NEG_INF, _categorical, apply_repetition_penalty_seen,
                            split_keys, window_seen_mask)
from ..ops.collectives import axis_of, reduce, whole_view
from .delay import ce_sums

TOPK_WIDTH = 64  # static top-k working set for dynamic per-channel k


class LocalMLP(nn.Module):
    """A SwiGLU adapter's ``gate``, ``up`` and ``down`` (reference MossTTSMLP
    :47-95, prenorm off), stacked on a leading axis of ``n`` when given."""

    def __init__(self, d_in: int, d_ffn: int, d_out: int, n: Optional[int] = None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        lead = () if n is None else (n,)
        self.gate = empty_param(lead + (d_in, d_ffn), dtype, device)
        self.up = empty_param(lead + (d_in, d_ffn), dtype, device)
        self.down = empty_param(lead + (d_ffn, d_out), dtype, device)


def _mlp(p: LocalMLP, x: torch.Tensor, idx: Optional[int] = None) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.local._mlp``: adapter ``idx`` of a stack
    through ``take_weight`` (an int8 stack's values and scales together)."""
    if idx is None:
        return swiglu(x, p.gate, p.up, p.down)
    return swiglu(x, take_weight(p.gate, idx), take_weight(p.up, idx),
                  take_weight(p.down, idx))


class LocalParams(nn.Module):
    """Ports the ``init_local_params`` tree: ``text_emb`` (V, D),
    ``audio_emb`` (n_vq, Va, D), ``backbone`` and ``local`` (Qwen3 stacks
    without embeddings), the adapters ``mlp_in`` (D -> Dl),
    ``mlp_out_text`` and the stacked ``mlp_out_audio`` (Dl -> D),
    ``ln_text`` (D,), ``ln_audio`` (n_vq, D), ``text_head`` (D, V) and
    ``audio_heads`` (n_vq, D, Va)."""

    def __init__(self, cfg: LocalConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        lc = cfg.language_config
        D, Dl, F, Va = lc.hidden_size, cfg.local_hidden_size, \
            cfg.additional_mlp_ffn_hidden_size, cfg.audio_emb_vocab
        kw = dict(dtype=dtype, device=device)
        self.text_emb = empty_param((lc.vocab_size, D), dtype, device)
        self.audio_emb = empty_param((cfg.n_vq, Va, D), dtype, device)
        self.backbone = Qwen3Params(lc, with_embed=False, **kw)
        self.local = Qwen3Params(cfg.local_transformer_config, with_embed=False, **kw)
        self.mlp_in = LocalMLP(D, F, Dl, **kw)
        self.mlp_out_text = LocalMLP(Dl, F, D, **kw)
        self.mlp_out_audio = LocalMLP(Dl, F, D, cfg.n_vq, **kw)
        self.ln_text = empty_param((D,), dtype, device)
        self.ln_audio = empty_param((cfg.n_vq, D), dtype, device)
        self.text_head = empty_param((D, lc.vocab_size), dtype, device)
        self.audio_heads = empty_param((cfg.n_vq, D, Va), dtype, device)


@torch.no_grad()
def init_local_params(cfg: LocalConfig, *, generator: torch.Generator, dtype=torch.float32,
                      device=None) -> LocalParams:
    """Ports ``mosstts_tpu.models.local.init_local_params``, drawing on
    ``device`` with ``generator``: norms at 1, every other leaf normal with
    std ``initializer_range`` (the Qwen3 stacks 0.02). The draws differ
    from JAX's; parity tests load JAX weights through ``utils.convert``."""
    params = LocalParams(cfg, dtype=dtype, device=device)
    fill_qwen3_params_(params.backbone, generator)
    fill_qwen3_params_(params.local, generator)
    for name, p in params.named_parameters():
        if name.startswith(("backbone.", "local.")):
            continue
        if name in ("ln_text", "ln_audio"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, cfg.initializer_range, generator=generator)
    return params


def local_embed(params: LocalParams, cfg: LocalConfig, ids: torch.Tensor,
                n_vq_infer: int) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.local.local_embed``: the sum of the text
    embedding and the embeddings of channels 1..n_vq_infer (reference
    _prepare_multi_modal_inputs :515-530 honours the truncation)."""
    Va = cfg.audio_emb_vocab
    emb = params.text_emb[ids[..., 0].long()]
    n = min(cfg.n_vq, n_vq_infer)
    if n > 0:
        flat = params.audio_emb[:n].reshape(n * Va, -1)
        offs = torch.arange(n, device=ids.device) * Va
        audio = flat[ids[..., 1:1 + n].long().clamp(0, Va - 1) + offs]
        emb = emb + audio.to(emb.dtype).sum(dim=-2)
    return emb


def local_loss(
    params: LocalParams, cfg: LocalConfig,
    ids: torch.Tensor,  # (B, T, 1+n_vq)
    attention_mask: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T, 1+n_vq), -100 ignore
    channel_weights: Optional[torch.Tensor] = None,  # (C,)
    n_vq_infer: Optional[int] = None,
    remat: bool = False,
):
    """Ports ``mosstts_tpu.models.local.local_loss``: the teacher-forced
    training loss (reference MossTTSDelayModel.forward,
    moss_tts_local/modeling_moss_tts.py:652-743). The backbone's hidden
    state is depth position 0; positions 1..C-1 embed the label channels
    0..C-2 (zero where a label is -100); the depth transformer (no rotary
    embedding) runs over (B*T, C, Dl) blocks; each channel's cross-entropy
    is its mean over valid labels, and the loss their mean weighted by
    ``channel_weights / channel_weights.sum()``. The backbone embeds the
    first ``n_vq_infer`` audio channels only, as in JAX. Returns (loss,
    {"loss_all" (C,)}). The stacked tables, adapters, norms and heads are
    split once (``unbind``), so each stack's backward is one stack of its
    per-channel gradients. On a sharded model (``parallel/mesh.py``) the
    backbone and depth stacks run tensor-parallel, the tables, adapters and
    heads (indexed per channel) are gathered whole, and each channel's
    sums and counts are summed over ``"data"``."""
    tp, dp = axis_of(params, "model"), axis_of(params, "data")
    params = whole_view(params, tp, keep=("backbone", "local"))
    B, T, C = ids.shape
    lc, lcfg = cfg.language_config, cfg.local_transformer_config
    dev = ids.device
    n = n_vq_infer or cfg.n_vq
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    embeds = local_embed(params, cfg, ids, n)
    hidden, _ = qwen3_forward(params.backbone, lc, embeds, positions=positions,
                              kv_valid=attention_mask.bool(), remat=remat)  # (B, T, D)

    Va = cfg.audio_emb_vocab
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    audio_emb = params.audio_emb.unbind(0)
    chans = [hidden, torch.where(valid[..., 0:1], params.text_emb[safe[..., 0]], 0.0)]
    for i in range(C - 2):
        e = audio_emb[i][safe[..., i + 1].clamp(0, Va - 1)]
        chans.append(torch.where(valid[..., i + 1:i + 2], e, 0.0))
    blocks = _mlp(params.mlp_in, torch.stack(chans, dim=2))  # (B, T, C, Dl)
    h, _ = qwen3_forward(
        params.local, lcfg, blocks.reshape(B * T, C, -1),
        positions=torch.arange(C, dtype=torch.int32, device=dev)[None].expand(B * T, C),
        kv_valid=torch.ones((B * T, C), dtype=torch.bool, device=dev),
        use_rope=False, remat=remat)  # (B*T, C, Dl)

    def ce(logits, lab):  # the mean over the valid labels of one channel
        total, count = ce_sums(logits.reshape(1, B * T, -1), lab.reshape(1, B * T))
        return reduce(total[0], dp) / reduce(count[0], dp).clamp(min=1)

    eps = lcfg.rms_norm_eps
    y0 = rms_norm(_mlp(params.mlp_out_text, h[:, 0]), params.ln_text, eps)
    losses = [ce(dense(y0, params.text_head), labels[..., 0])]
    gate, up, down = (getattr(params.mlp_out_audio, k).unbind(0) for k in ("gate", "up", "down"))
    ln_audio, heads = params.ln_audio.unbind(0), params.audio_heads.unbind(0)
    for i in range(C - 1):
        y = rms_norm(swiglu(h[:, i + 1], gate[i], up[i], down[i]), ln_audio[i], eps)
        losses.append(ce(dense(y, heads[i]), labels[..., i + 1]))
    loss_all = torch.stack(losses)
    w = (torch.ones((C,), dtype=torch.float32, device=dev) if channel_weights is None
         else torch.as_tensor(channel_weights, dtype=torch.float32, device=dev))
    w = w / w.sum()
    return (loss_all * w).sum(), {"loss_all": loss_all}


class LocalSampling(NamedTuple):
    """Ports ``mosstts_tpu.models.local.LocalSampling``: per-channel (C,)
    tensors built from ``DelayGenerationConfig.layers``
    (moss_tts_local/README.md:108-126)."""

    temperature: torch.Tensor  # (C,) f32
    top_p: torch.Tensor  # (C,) f32
    top_k: torch.Tensor  # (C,) int32 (0 => the whole TOPK_WIDTH subset)
    repetition_penalty: torch.Tensor  # (C,) f32 (1.0 => off; channel 0 always off)
    do_sample: torch.Tensor  # (C,) bool


def make_local_sampling(layers, do_samples, channels: int, *, device=None) -> LocalSampling:
    """Ports ``mosstts_tpu.models.local.make_local_sampling``: channel i's
    ``temperature``, ``top_p``, ``top_k`` and ``repetition_penalty`` from
    ``layers[i]`` (defaults 1.0, 1.0, 0, 1.0), sampled unless
    ``do_samples[i]`` is False."""
    def get(i, key, default):
        if layers is None or i >= len(layers):
            return default
        v = layers[i].get(key)
        return default if v is None else v

    def t(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device)

    return LocalSampling(
        temperature=t([float(get(i, "temperature", 1.0)) for i in range(channels)],
                      torch.float32),
        top_p=t([float(get(i, "top_p", 1.0)) for i in range(channels)], torch.float32),
        top_k=t([int(get(i, "top_k", 0) or 0) for i in range(channels)], torch.int32),
        repetition_penalty=t([1.0 if i == 0 else float(get(i, "repetition_penalty", 1.0))
                              for i in range(channels)], torch.float32),
        do_sample=t([bool(do_samples[i]) if do_samples is not None else True
                     for i in range(channels)], torch.bool))


def _sample_channel(keys, logits: torch.Tensor, temp, top_p, top_k, do_sample) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.local._sample_channel``: the HF warper
    order (CustomMixin :356-374), temperature, then top-k as a rank mask
    inside the static ``TOPK_WIDTH`` subset (so ``top_k = 0`` samples within
    the top 64), then top-p (``cum - probs < p``), then the draw; a greedy
    row takes the argmax of the unscaled logits. The controls are 0-dim
    tensors."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temp, min=1e-6)
    width = min(TOPK_WIDTH, logits.shape[-1])
    vals, idx = torch.topk(scaled, width, dim=-1)
    ranks = torch.arange(width, device=logits.device)
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=width), width)
    vals = torch.where(ranks[None, :] < k_eff, vals, NEG_INF)
    probs = torch.softmax(vals.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    vals = torch.where((cum - probs) < top_p, vals, NEG_INF)
    choice = _categorical(keys, vals.float())
    sampled = torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(do_sample, sampled, greedy)


class LocalGenState(NamedTuple):
    """Ports ``mosstts_tpu.models.local.LocalGenState``; ``rng`` one
    threefry key per row, and ``depth`` the depth transformer's
    cache of ``channels`` slots (JAX makes it anew in every frame)."""

    cache: Any  # KVCache (L, B, KV, S, hd)
    kv_valid: torch.Tensor  # (B, S) bool
    cur_ids: torch.Tensor  # (B, 1, C)
    pos: torch.Tensor  # int32: 0-dim, or (B,) per row
    step: torch.Tensor  # int32: 0-dim, or (B,) per row
    rng: torch.Tensor  # (B, 2) int64 per-row threefry keys
    unfinished: torch.Tensor  # (B,) bool
    seen_text: torch.Tensor  # (B, V) rep-penalty bitmask, text channel
    seen_audio: torch.Tensor  # (B, n_vq, Va)
    out: torch.Tensor  # (B, max_new, C) int32
    depth: Any  # KVCache (Ll, B, KV, channels, hd)


def _mark_seen_(seen: torch.Tensor, tokens: torch.Tensor, active: torch.Tensor) -> None:
    """``seen[..., tokens] |= active`` in place: ``ops.sampling.seen_mask_update``
    (which returns a new mask) written into ``seen``."""
    idx = tokens.long().unsqueeze(-1)
    seen.scatter_(-1, idx, seen.gather(-1, idx) | active.unsqueeze(-1))


def _depth_decode(params: LocalParams, cfg: LocalConfig, keys: torch.Tensor, g: torch.Tensor,
                  sampling: LocalSampling, seen_text, seen_audio: torch.Tensor,
                  n_vq_infer: int, *, cache: Optional[KVCache] = None):
    """Ports ``mosstts_tpu.models.local._depth_decode``: one frame's depth
    pass from the backbone's last hidden ``g`` (B, D), the text channel and
    ``n_vq_infer`` audio channels, each a single cached step of the depth
    transformer (no rotary embedding, slot k at depth step k). ``cache``
    (``channels`` slots or more) is zeroed and used; without it a cache of
    ``1 + min(n_vq, n_vq_infer)`` slots is made. Returns (tok0 (B,) int32,
    audio (B, n_vq) int32, the channels past ``n_vq_infer`` zero-filled,
    reference :425-427)."""
    lcfg = cfg.local_transformer_config
    B = g.shape[0]
    dev = g.device
    C_run = 1 + min(cfg.n_vq, n_vq_infer)
    if cache is None:
        cache = init_kv_cache(lcfg, B, C_run, dtype=g.dtype, device=dev)
    else:
        for buf in cache:
            buf[:, :, :, :C_run].zero_()
    S = cache.max_len
    slots = torch.arange(S, device=dev)[None]
    eps = lcfg.rms_norm_eps

    def depth_step(x, k: int):
        h, _ = qwen3_forward(
            params.local, lcfg, x[:, None, :],
            positions=torch.full((B, 1), k, dtype=torch.int32, device=dev),
            kv_valid=(slots <= k).expand(B, S), cache=cache, cache_offset=k,
            use_rope=False, attend_len=C_run)
        return h[:, 0]

    rngs = threefry.split(keys, C_run)  # (B, C_run, 2)
    h0 = depth_step(_mlp(params.mlp_in, g), 0)
    y0 = rms_norm(_mlp(params.mlp_out_text, h0), params.ln_text, eps)
    logits0 = dense(y0, params.text_head).float()
    s = sampling
    tok0 = _sample_channel(rngs[:, 0], logits0, s.temperature[0], s.top_p[0], s.top_k[0],
                           s.do_sample[0])
    x = _mlp(params.mlp_in, params.text_emb[tok0.long()])

    toks = []
    for k in range(1, C_run):
        h = depth_step(x, k)
        y = rms_norm(_mlp(params.mlp_out_audio, h, idx=k - 1), params.ln_audio[k - 1], eps)
        logits = head_logits(y, params.audio_heads, k - 1)
        logits[:, cfg.audio_pad_code] = NEG_INF
        do_s = s.do_sample[k]
        # processors (incl. the penalty) only run on sampled channels
        # (reference CustomMixin :361-363 skips when do_samples[i] is False)
        rp = torch.where(do_s, s.repetition_penalty[k], 1.0)
        logits = apply_repetition_penalty_seen(logits, seen_audio[:, k - 1], rp)
        tok = _sample_channel(rngs[:, k], logits, s.temperature[k], s.top_p[k], s.top_k[k], do_s)
        toks.append(tok)
        if k + 1 < C_run:  # the next depth step embeds this token
            x = _mlp(params.mlp_in, params.audio_emb[k - 1][tok.long()])
    audio = torch.zeros((B, cfg.n_vq), dtype=torch.int32, device=dev)
    if toks:
        audio[:, :len(toks)] = torch.stack(toks, dim=1)
    return tok0, audio


def local_frame_step(params: LocalParams, cfg: LocalConfig, state: LocalGenState,
                     sampling: LocalSampling, *, n_vq_infer: int, eos_token_id: int,
                     attend_len: Optional[int] = None) -> LocalGenState:
    """Ports ``mosstts_tpu.models.local.local_frame_step``: one frame of the
    whole batch. A scalar cursor is the solo engine; (B,) cursors are the
    server's slots, each at its own conversation length: only advancing
    rows validate their next cache slot, and stopped or idle rows freeze
    their cursors. Finished rows emit EOS on channel 0 and the pad code
    elsewhere (reference :429-432)."""
    B = state.cur_ids.shape[0]
    dev = state.cur_ids.device
    per_row = state.pos.ndim == 1
    embeds = local_embed(params, cfg, state.cur_ids, n_vq_infer)
    positions = (state.pos[:, None] if per_row else state.pos.expand(B, 1)).to(torch.int32)
    hidden, _ = qwen3_forward(
        params.backbone, cfg.language_config, embeds, positions=positions,
        kv_valid=state.kv_valid, cache=state.cache, cache_offset=state.pos,
        attend_len=attend_len)
    rng, rng_depth = split_keys(state.rng, 2)
    tok0, audio = _depth_decode(params, cfg, rng_depth, hidden[:, -1], sampling,
                                state.seen_text, state.seen_audio, n_vq_infer,
                                cache=state.depth)
    was = state.unfinished
    tok0 = torch.where(was, tok0, eos_token_id)
    audio = torch.where(was[:, None], audio, cfg.audio_pad_code)
    unfinished = was & (tok0 != eos_token_id)

    n_act = min(cfg.n_vq, n_vq_infer)
    active = (torch.arange(cfg.n_vq, device=dev)[None, :] < n_act) & was[:, None]
    _mark_seen_(state.seen_audio, audio.clamp(0, cfg.audio_emb_vocab - 1), active)
    _mark_seen_(state.seen_text, tok0, was)

    frame = torch.cat([tok0[:, None], audio], dim=1)
    cap, S = state.out.shape[1], state.kv_valid.shape[1]
    if per_row:
        rows = torch.arange(B, device=dev)
        state.out[rows, state.step.clamp(0, cap - 1).long()] = frame
        nxt = (state.pos + 1).clamp(0, S - 1).long()
        state.kv_valid[rows, nxt] = state.kv_valid[rows, nxt] | was
        adv = was.to(torch.int32)
        pos_next, step_next = state.pos + adv, state.step + adv
    else:
        state.out.index_copy_(1, state.step.clamp(0, cap - 1).long().reshape(1),
                              frame[:, None, :])
        # a slot past the capacity is dropped, as JAX's scatter drops it
        nxt = (state.pos + 1).clamp(max=S - 1).long().reshape(1)
        state.kv_valid.index_copy_(1, nxt, state.kv_valid.index_select(1, nxt)
                                   | (state.pos + 1 < S))
        pos_next, step_next = state.pos + 1, state.step + 1
    return state._replace(cur_ids=frame[:, None, :].to(state.cur_ids.dtype), pos=pos_next,
                          step=step_next, unfinished=unfinished, rng=rng)


def local_prefill_split(params: LocalParams, cfg: LocalConfig, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor, *, max_new_tokens: int, cache_len: int,
                        rng: torch.Tensor, n_vq_infer: int, dtype=torch.bfloat16,
                        cache: Optional[KVCache] = None,
                        depth: Optional[KVCache] = None) -> LocalGenState:
    """Ports ``mosstts_tpu.models.local.local_prefill_split``: prefill all
    but the last prompt row; the last row becomes ``cur_ids``, so the first
    frame step produces the first frame. The repetition-penalty masks come
    from the prompt. ``cache`` (a linear cache of ``cache_len`` slots or
    more) is written in place instead of a new one, and ``depth`` (a depth
    cache) carried into the state. ``rng`` (B, 2), one key per row (a
    prefill draws nothing)."""
    B, T, C = input_ids.shape
    dev = input_ids.device
    lc = cfg.language_config
    Va = cfg.audio_emb_vocab
    if tuple(rng.shape) != (B, 2):
        raise ValueError(f"need one key per row: {tuple(rng.shape)} for batch {B}")
    if cache is None:
        cache = init_kv_cache(lc, B, cache_len, dtype=dtype, device=dev)
    kv_valid = torch.zeros((B, cache_len), dtype=torch.bool, device=dev)
    kv_valid[:, :T] = attention_mask
    positions = torch.arange(T - 1, dtype=torch.int32, device=dev)[None].expand(B, T - 1)
    embeds = local_embed(params, cfg, input_ids[:, :T - 1], n_vq_infer)
    qwen3_forward(params.backbone, lc, embeds, positions=positions, kv_valid=kv_valid,
                  cache=cache, cache_offset=0)
    seen_text = window_seen_mask(input_ids[..., 0], lc.vocab_size, valid=attention_mask)
    seen_audio = window_seen_mask(
        input_ids[:, :, 1:].clamp(0, Va - 1).transpose(1, 2), Va,
        valid=attention_mask[:, None, :].expand(B, C - 1, T))
    return LocalGenState(
        cache=cache, kv_valid=kv_valid, cur_ids=input_ids[:, T - 1:T, :],
        pos=torch.full((), T - 1, dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev), rng=rng,
        unfinished=torch.ones((B,), dtype=torch.bool, device=dev),
        seen_text=seen_text.contiguous(), seen_audio=seen_audio.contiguous(),
        out=torch.zeros((B, max_new_tokens, C), dtype=torch.int32, device=dev),
        depth=depth if depth is not None else init_kv_cache(
            cfg.local_transformer_config, B, cfg.channels, dtype=dtype, device=dev))


def init_local_state(cfg: LocalConfig, batch: int, cache_len: int, out_len: int,
                     rng: torch.Tensor, *, per_row: bool = False,
                     dtype=torch.bfloat16, device=None) -> LocalGenState:
    """A zeroed state of ``batch`` rows: a linear backbone cache of
    ``cache_len`` slots, ``out_len`` frames of output, every row finished
    (idle); a scalar cursor, or (B,) cursors with ``per_row`` (the JAX
    server's ``_empty_state``, ``local_batch_server.py:111``)."""
    if tuple(rng.shape) != (batch, 2):
        raise ValueError(f"need one key per row: {tuple(rng.shape)} for batch {batch}")
    lc = cfg.language_config

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    cursor = (batch,) if per_row else ()
    return LocalGenState(
        cache=init_kv_cache(lc, batch, cache_len, dtype=dtype, device=device),
        kv_valid=zeros((batch, cache_len), torch.bool),
        cur_ids=zeros((batch, 1, cfg.channels), torch.int64),
        pos=zeros(cursor, torch.int32), step=zeros(cursor, torch.int32),
        rng=rng.to(device=device, dtype=torch.int64).clone(),
        unfinished=zeros((batch,), torch.bool),
        seen_text=zeros((batch, lc.vocab_size), torch.bool),
        seen_audio=zeros((batch, cfg.n_vq, cfg.audio_emb_vocab), torch.bool),
        out=zeros((batch, out_len, cfg.channels), torch.int32),
        depth=init_kv_cache(cfg.local_transformer_config, batch, cfg.channels, dtype=dtype,
                            device=device))


# the fields a prefill gives a state besides its caches
PREFILL_FIELDS = ("kv_valid", "cur_ids", "pos", "step", "unfinished", "seen_text", "seen_audio")


def copy_local_state_(dst: LocalGenState, src: LocalGenState) -> None:
    """Copy a prefill's state ``src`` into the static ``dst`` (same batch
    and cursor shape) in place; caches the prefill wrote in place are not
    copied. ``dst.out`` may hold more frames than ``src.out``: the rest is
    zeroed."""
    for d, s in zip(tuple(dst.cache) + tuple(dst.depth), tuple(src.cache) + tuple(src.depth)):
        if d is not s:
            d.copy_(s)
    for name in PREFILL_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))
    n = src.out.shape[1]
    dst.out[:, :n].copy_(src.out)
    dst.out[:, n:].zero_()
