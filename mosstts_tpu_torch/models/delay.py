"""MossTTSDelay: the multi-head RVQ transformer with delay-pattern decoding.

Ports ``mosstts_tpu/models/delay.py``: ``init_delay_params``,
``delay_embed``, ``_audio_head_logits``, ``delay_forward`` (with
``hidden_out_layers``, ``text_lazy`` and ``pipeline``),
``DelaySampling``/``make_sampling``, ``DelayGenState``, ``delay_prefill``,
``_text_preds``, ``_sample_text_full``, ``_sample_text_lazy``,
``_delay_sample_and_update``,
``delay_decode_step``, ``delay_decode_until_event``,
``delay_generate_on_device``, and the training loss ``delay_loss`` with
``delay_train_step``. The 32 audio tables and 33 heads stay stacked
(``(n_vq, Va, D)`` and ``(n_vq, D, Va)``) so the embedding sum and the head
projection are one gather and one batched product. The heads may be int8
``QuantWeight``s (``ops/quant.py``, ``DelayEngine.quantize``): the text head
goes through ``dense``, the audio stack through one W8A16 launch.

Tensor parallelism (``parallel/mesh.delay_param_specs``): the text
embedding is split by vocab rows (a masked lookup), the audio tables by
codebooks; this rank's part of the embedding sum is summed over the
``"model"`` axis once. The text head is split by vocab columns and the
audio heads by codebooks: each ends in an ``all_gather`` to the full
logits, so every rank samples the same tokens from the same keys. Under data parallelism the loss sums and label counts are
summed over ``"data"`` before the division (the loss is normalised by the
global count of valid labels, as JAX's is).

State updates follow the JAX package's order: ``kv_valid[pos]`` is set by
the sampler, before the next forward writes K/V at ``pos``; ``pos``
advances in the forward. Writes at ``step``/``pos`` past the end of their
buffer are dropped, as JAX's ``mode="drop"`` does, by masking. The cache,
``out``, ``out_valid`` and ``kv_valid`` are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import DelayConfig
from ..nn.qwen3 import (Qwen3Params, empty_param, fill_qwen3_params_, init_kv_cache,
                        init_quant_kv_cache, qwen3_forward, rank_config)
from ..ops.basic import dense, put_drop_
from ..ops.kernels import graph_loop, launches, threefry, w8_gemm
from ..ops.quant import is_quantized
from ..ops.sampling import (
    align_rows,
    apply_repetition_penalty_seen,
    find_last_equal,
    sample_topk_topp,
    seen_mask_update,
    split_keys,
)
from ..ops.collectives import axis_of, enter, gather, reduce, vocab_lookup

SENTINEL = 1 << 30  # int32 in the state tensors
NEG_INF = -1e30


class DelayParams(nn.Module):
    """Ports the ``init_delay_params`` pytree: ``backbone``, ``audio_emb``
    (n_vq, Va, D), ``text_head`` (D, V), ``audio_heads`` (n_vq, D, Va)."""

    def __init__(self, cfg: DelayConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        lc = cfg.language_config
        D, Va = lc.hidden_size, cfg.audio_emb_vocab
        self.backbone = Qwen3Params(lc, dtype=dtype, device=device, with_embed=True)
        self.audio_emb = empty_param((cfg.n_vq, Va, D), dtype, device)
        self.text_head = empty_param((D, lc.vocab_size), dtype, device)
        self.audio_heads = empty_param((cfg.n_vq, D, Va), dtype, device)


@torch.no_grad()
def init_delay_params(cfg: DelayConfig, *, generator: torch.Generator, dtype=torch.float32,
                      device=None) -> DelayParams:
    """Ports ``mosstts_tpu.models.delay.init_delay_params``, drawing on
    ``device``."""
    params = DelayParams(cfg, dtype=dtype, device=device)
    fill_qwen3_params_(params.backbone, generator)
    for p in (params.audio_emb, params.text_head, params.audio_heads):
        p.normal_(0.0, cfg.initializer_range, generator=generator)
    return params


def rank_delay_config(cfg: DelayConfig, params: DelayParams) -> DelayConfig:
    """``cfg`` with the backbone's head counts of ``params``' own weights
    (``nn.qwen3.rank_config``): a tensor-parallel rank's caches hold its KV
    heads."""
    return dataclasses.replace(cfg, language_config=rank_config(cfg.language_config,
                                                                params.backbone))


def delay_embed(params: DelayParams, cfg: DelayConfig, ids: torch.Tensor) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.delay.delay_embed``: ids (B, T, 1+n_vq) ->
    summed embeddings (B, T, D). Channel 0 uses the text embedding, channels
    1..n_vq the stacked audio tables. Under tensor parallelism this rank
    looks up its vocab rows and its codebooks, and the ranks' sums are
    summed."""
    Va = cfg.audio_emb_vocab
    tp = axis_of(params, "model")
    emb = vocab_lookup(params.backbone.embed, ids[..., 0].long(), tp)
    n = params.audio_emb.shape[0]  # this rank's codebooks
    lo = 0 if tp is None else tp.index * n
    flat = params.audio_emb.reshape(n * Va, -1)
    offs = torch.arange(n, device=ids.device) * Va
    audio = flat[ids[..., 1 + lo:1 + lo + n].long() + offs]  # (B, T, n, D)
    return reduce(emb + audio.to(emb.dtype).sum(dim=-2), tp)


def _audio_head_logits(hidden: torch.Tensor, heads) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.delay._audio_head_logits``: (B, T, D) x
    (n, D, V) -> (B, T, n, V), the float32 accumulator as it is (no rounding
    to the weight dtype). The rows go in as one (B*T, D) matrix against the
    (n, D, V) stack, read in place: no float copy of the heads (269 MB in
    bf16 at 8B) on the card and no per-head loop.

    * int8 ``QuantWeight`` heads: ``(x @ q[n]) * scale[n]``, one W8A16
      launch over the whole stack with f32 output.
    * bf16 heads on the card: one batched product with a float32 output
      (``torch.bmm(..., out_dtype=torch.float32)``).
    * float32 heads, bf16 heads on the CPU, and bf16 heads wherever autograd
      records the product (training): the product in float32. The
      ``out_dtype`` overload of ``torch.bmm`` has no derivative."""
    if is_quantized(heads):
        return w8_gemm.w8a16_gemm(hidden.contiguous(), heads.q, heads.scale, torch.float32)
    B, T, D = hidden.shape
    n, V = heads.shape[0], heads.shape[2]
    x = hidden.reshape(B * T, D)
    records = torch.is_grad_enabled() and (x.requires_grad or heads.requires_grad)
    if x.device.type == "cuda" and heads.dtype != torch.float32 and not records:
        logits = torch.bmm(x.expand(n, B * T, D), heads, out_dtype=torch.float32)
    else:
        logits = torch.matmul(x.float(), heads.float())  # (n, B*T, V)
    return logits.permute(1, 0, 2).reshape(B, T, n, V)


def _per_head_logits(hs: torch.Tensor, heads) -> torch.Tensor:
    """The ``hidden_out_layers`` audio heads (JAX ``delay_forward``'s
    ``nbtd,ndv->btnv`` einsum): each head n reads its own source hidden
    state, (n, B, T, D) x (n, D, V) -> (B, T, n, V) in float32. An int8
    stack computes ``(x @ q[n].astype(x.dtype)) * scale[n]``, as JAX does,
    outside any kernel (a bf16 copy of the int8 values per call)."""
    n, B, T, D = hs.shape
    x = hs.reshape(n, B * T, D)
    w = heads.q if is_quantized(heads) else heads
    if x.device.type == "cuda" and x.dtype != torch.float32:
        logits = torch.bmm(x, w.to(x.dtype), out_dtype=torch.float32)
    else:
        logits = torch.matmul(x.float(), w.float())
    if is_quantized(heads):
        logits = logits * heads.scale[:, None]
    return logits.reshape(n, B, T, -1).permute(1, 2, 0, 3)


def delay_forward(
    params: DelayParams,
    cfg: DelayConfig,
    ids: torch.Tensor,  # (B, T, 1+n_vq)
    *,
    positions: torch.Tensor,
    kv_valid: torch.Tensor,
    cache=None,
    cache_offset=0,
    attend_len: Optional[int] = None,
    hidden_out_layers: Optional[Sequence[int]] = None,
    logits_len: Optional[int] = None,
    text_lazy: bool = False,
    remat: bool = False,
    pipeline=None,
):
    """Ports ``mosstts_tpu.models.delay.delay_forward``. Returns
    (text_logits (B, T, V) f32, audio_logits (B, T, n_vq, Va) f32, cache);
    the last audio vocab column (the pad code) is masked to NEG_INF.
    ``logits_len`` keeps only the last positions for the heads.
    ``hidden_out_layers`` (1 + n_vq indices into HF's hidden states: 0 the
    embeddings, -1 the final-normed last layer) sources the text head
    (entry 0) and each audio head from its own backbone layer. ``remat``
    (no cache) recomputes the backbone's layers in the backward pass.
    ``text_lazy`` returns the text head's source hidden state (B, T, D) in
    place of the text logits (``_sample_text_lazy`` projects it).
    ``pipeline=(mesh, n_micro)`` (training, no cache) runs the backbone's
    layers as a GPipe schedule over the mesh's ``"stage"`` axis
    (``parallel/pipeline.py``); the embeddings and the heads stay
    replicated."""
    embeds = delay_embed(params, cfg, ids)
    lc = cfg.language_config
    tp = axis_of(params, "model")
    kw = dict(positions=positions, kv_valid=kv_valid, cache=cache, cache_offset=cache_offset,
              attend_len=attend_len, remat=remat)
    if text_lazy and tp is not None:
        raise ValueError("text_lazy takes an unsharded text head")
    if hidden_out_layers is None:
        if pipeline is not None:
            if cache is not None:
                raise ValueError("pipeline= is a training-path option (no cache)")
            from ..parallel.pipeline import pipelined_qwen3_forward

            pp_mesh, n_micro = pipeline
            hidden = pipelined_qwen3_forward(params.backbone, lc, embeds, positions=positions,
                                             kv_valid=kv_valid, mesh=pp_mesh, n_micro=n_micro,
                                             remat=remat)
        else:
            hidden, cache = qwen3_forward(params.backbone, lc, embeds, **kw)
        if logits_len is not None:
            hidden = hidden[:, -logits_len:]
        hidden = enter(hidden, tp)
        text_logits = (hidden if text_lazy else
                       gather(dense(hidden, params.text_head).float(), -1, tp))
        audio_logits = gather(_audio_head_logits(hidden, params.audio_heads), 2, tp)
    else:
        if len(hidden_out_layers) != 1 + cfg.n_vq:
            raise ValueError("hidden_out_layers must have 1 + n_vq entries")
        n_hs = lc.num_hidden_layers + 1
        idxs = [int(i) % n_hs for i in hidden_out_layers]
        _, (cache, states) = qwen3_forward(params.backbone, lc, embeds,
                                           output_hidden_states=True, **kw)
        if logits_len is not None:
            states = [h[:, -logits_len:] for h in states]
        n = params.audio_heads.shape[0]  # this rank's codebooks
        lo = 0 if tp is None else tp.index * n
        text_logits = (states[idxs[0]] if text_lazy else
                       gather(dense(enter(states[idxs[0]], tp), params.text_head).float(), -1, tp))
        audio_logits = gather(_per_head_logits(
            torch.stack([enter(states[i], tp) for i in idxs[1 + lo:1 + lo + n]]),
            params.audio_heads), 2, tp)
    audio_logits[..., -1] = NEG_INF
    return text_logits, audio_logits, cache


class DelaySampling(NamedTuple):
    """Ports ``mosstts_tpu.models.delay.DelaySampling``: each knob is a
    0-dim tensor, or (B,) for per-row values."""

    text_temperature: torch.Tensor
    text_top_p: torch.Tensor
    audio_temperature: torch.Tensor
    audio_top_p: torch.Tensor
    audio_repetition_penalty: torch.Tensor
    text_do_sample: torch.Tensor
    audio_do_sample: torch.Tensor
    audio_rp_cross_batch: torch.Tensor


def make_sampling(
    text_temperature=1.5, text_top_p=1.0, audio_temperature=1.7,
    audio_top_p=0.8, audio_repetition_penalty=1.0,
    audio_rp_cross_batch=False, *, device=None,
) -> DelaySampling:
    """Ports ``mosstts_tpu.models.delay.make_sampling``: temperature <= 0
    means greedy for that row."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    tt, at = f32(text_temperature), f32(audio_temperature)
    return DelaySampling(
        text_temperature=torch.where(tt > 0, tt, 1.0),
        text_top_p=f32(text_top_p),
        audio_temperature=torch.where(at > 0, at, 1.0),
        audio_top_p=f32(audio_top_p),
        audio_repetition_penalty=f32(audio_repetition_penalty),
        text_do_sample=tt > 0,
        audio_do_sample=at > 0,
        audio_rp_cross_batch=torch.as_tensor(bool(audio_rp_cross_batch), device=device),
    )


class DelayGenState(NamedTuple):
    """Ports ``mosstts_tpu.models.delay.DelayGenState``; ``rng`` holds one
    threefry key per row, (B, 2) int64 (``ops.sampling``)."""

    cache: Any  # KVCache | QuantKVCache | PagedKVCache | QuantPagedKVCache
    kv_valid: torch.Tensor  # (B, S) bool
    cur_ids: torch.Tensor  # (B, 1, C) token to feed next forward
    pos: torch.Tensor  # (B,) int32 cache slot where cur_ids will be written
    step: torch.Tensor  # (B,) int32 per-row decode step counter
    rng: torch.Tensor  # (B, 2) int64 per-row threefry keys
    is_stopping: torch.Tensor  # (B,) bool
    is_audio: torch.Tensor  # (B,) bool
    audio_lengths: torch.Tensor  # (B,) int32
    delayed: torch.Tensor  # (B,) int32, SENTINEL when inactive
    seen: torch.Tensor  # (B, n_vq, Va) bool rep-penalty mask
    out: torch.Tensor  # (B, max_new, C) int32 generated frames
    out_valid: torch.Tensor  # (B, max_new) bool


def _set_rows_(buf: torch.Tensor, col: torch.Tensor, val: torch.Tensor) -> None:
    """``buf[b, col[b]] = val[b]`` in place, dropping rows whose ``col`` is
    past the end (JAX ``.at[rows, col].set(val, mode="drop")``)."""
    B, n = buf.shape[:2]
    rows = torch.arange(B, device=buf.device)
    put_drop_(buf, (rows, col.clamp(max=n - 1).long()), val, col < n)


def delay_prefill(
    params: DelayParams,
    cfg: DelayConfig,
    input_ids: torch.Tensor,  # (B, T, C) left-padded
    attention_mask: torch.Tensor,  # (B, T) bool
    *,
    max_new_tokens: int,
    cache_len: int,
    rng: torch.Tensor,
    sampling: DelaySampling,
    top_k_text: int = 50,
    top_k_audio: int = 25,
    dtype=torch.bfloat16,
    kv_quant: bool = False,
    cache=None,
    hidden_out_layers: Optional[Sequence[int]] = None,
) -> DelayGenState:
    """Ports ``mosstts_tpu.models.delay.delay_prefill``: run the prompt into
    a fresh linear cache (int8 with per-slot scales when ``kv_quant``; the
    prompt then attends its own k/v and only the cache write is quantized),
    then sample the first frame from its last position. ``rng`` is one key
    (2,), split into one per row as JAX does, or (B, 2) per-row keys.
    ``cache``, a linear cache of that kind with
    ``cache_len`` slots, is zeroed and written in place instead of a new
    one (the engine's static decode state)."""
    B, T, C = input_ids.shape
    n_vq, Va = cfg.n_vq, cfg.audio_emb_vocab
    dev = input_ids.device
    if rng.ndim == 1:  # one key: a row each (JAX's split(rng, B))
        rng = threefry.split(rng[None].to(dev), B)[0]
    elif rng.shape[0] != B:
        raise ValueError(f"need one key per row: {rng.shape[0]} for batch {B}")

    if cache is None:
        lc = rank_delay_config(cfg, params).language_config  # this rank's KV heads
        cache = (init_quant_kv_cache(lc, B, cache_len, device=dev) if kv_quant
                 else init_kv_cache(lc, B, cache_len, dtype=dtype, device=dev))
    else:
        if cache.k.shape[1] != B or cache.max_len != cache_len or (
                len(cache) == 4) != kv_quant:
            raise ValueError("delay_prefill: the cache given is not a "
                             f"{'int8 ' if kv_quant else ''}cache of {B} rows and "
                             f"{cache_len} slots")
        for buf in cache:
            buf.zero_()
    kv_valid = torch.zeros((B, cache_len), dtype=torch.bool, device=dev)
    kv_valid[:, :T] = attention_mask
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)

    text_logits, audio_logits, cache = delay_forward(
        params, cfg, input_ids, positions=positions, kv_valid=kv_valid,
        cache=cache, cache_offset=0, hidden_out_layers=hidden_out_layers, logits_len=1,
    )

    # continuation init (reference generate :431-436)
    last_text = input_ids[:, -1, 0]
    is_cont = (last_text == cfg.audio_start_token_id) | (
        last_text == cfg.audio_assistant_gen_slot_token_id)
    start_idx = find_last_equal(input_ids[..., 0], cfg.audio_start_token_id)
    audio_start_mask = is_cont & (start_idx != -1)
    audio_lengths = torch.where(audio_start_mask, T - start_idx, 0).to(torch.int32)

    # the rep-penalty history includes the prompt's audio channels
    prompt_audio = input_ids[:, :, 1:].clamp(0, Va - 1).long().transpose(1, 2)  # (B, n_vq, T)
    # pad positions scatter into a spare column Va that is then dropped
    idx = torch.where(attention_mask[:, None, :], prompt_audio, Va)
    seen = torch.zeros((B, n_vq, Va + 1), dtype=torch.bool, device=dev)
    seen = seen.scatter_(2, idx, True)[..., :Va].contiguous()

    state = DelayGenState(
        cache=cache,
        kv_valid=kv_valid,
        cur_ids=torch.zeros((B, 1, C), dtype=input_ids.dtype, device=dev),
        pos=torch.full((B,), T, dtype=torch.int32, device=dev),
        step=torch.zeros((B,), dtype=torch.int32, device=dev),
        rng=rng,
        is_stopping=torch.zeros((B,), dtype=torch.bool, device=dev),
        is_audio=audio_start_mask,
        audio_lengths=audio_lengths,
        delayed=torch.full((B,), SENTINEL, dtype=torch.int32, device=dev),
        seen=seen,
        out=torch.zeros((B, max_new_tokens, C), dtype=torch.int32, device=dev),
        out_valid=torch.zeros((B, max_new_tokens), dtype=torch.bool, device=dev),
    )
    return _delay_sample_and_update(state, cfg, sampling, top_k_text, top_k_audio,
                                    text_logits[:, -1], audio_logits[:, -1])


def _text_preds(state: DelayGenState, cfg: DelayConfig):
    """Ports ``mosstts_tpu.models.delay._text_preds``: the text-channel
    predicates of the state machine."""
    n_vq = cfg.n_vq
    not_stop = ~state.is_stopping
    forced_delay = not_stop & (state.delayed < n_vq)
    forced_end = not_stop & (state.delayed == n_vq)
    sampling_text = not_stop & (state.delayed > n_vq)  # SENTINEL > n_vq
    is_audio = torch.where(forced_end, False, state.is_audio)
    first_step = state.step == 0
    early = state.step <= n_vq
    return not_stop, forced_delay, forced_end, sampling_text, is_audio, first_step, early


def _sample_text_full(keys, cfg: DelayConfig, s: DelaySampling, top_k_text: int,
                      text_logits: torch.Tensor,  # (B, V), temperature-scaled
                      is_audio, first_step, early) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.delay._sample_text_full``: masked
    full-vocab text sampling."""
    V = text_logits.shape[-1]
    vocab = torch.arange(V, device=text_logits.device)
    excl0 = ((vocab == cfg.pad_token_id)
             | (vocab == cfg.audio_assistant_gen_slot_token_id)
             | (vocab == cfg.audio_assistant_delay_slot_token_id)
             | (vocab == cfg.audio_end_token_id))
    allow1 = ((vocab == cfg.audio_assistant_gen_slot_token_id)
              | (vocab == cfg.audio_assistant_delay_slot_token_id))
    mask = ((excl0[None] & ~is_audio[:, None])
            | (~allow1[None] & is_audio[:, None])
            | (first_step[:, None] & (vocab == cfg.audio_assistant_delay_slot_token_id)[None])
            | (early[:, None] & (vocab == cfg.im_end_token_id)[None]))
    text_logits = torch.where(mask, NEG_INF, text_logits)
    return sample_topk_topp(keys, text_logits, top_k=top_k_text, top_p=s.text_top_p,
                            do_sample=s.text_do_sample)


def _text_logits2(hidden: torch.Tensor, text_head, cols: torch.Tensor) -> torch.Tensor:
    """The text head's logits at the columns ``cols`` only (f32), rounded
    to the activation dtype as ``dense()`` rounds the full logits."""
    if is_quantized(text_head):
        w2 = text_head.q.index_select(1, cols).to(hidden.dtype)
        logits2 = torch.matmul(hidden.float(), w2.float()) * text_head.scale[cols]
    else:
        logits2 = torch.matmul(hidden.float(), text_head.index_select(1, cols).float())
    return logits2.to(hidden.dtype).float()


def _lazy_branches(keys, cfg: DelayConfig, s: DelaySampling, top_k_text: int,
                   hidden: torch.Tensor, text_head, is_audio, first_step, early):
    """JAX's two ``lax.cond`` branches of ``_sample_text_lazy`` as
    functions of no argument: ``full`` (the full-vocab head and sampling)
    and ``cheap`` (the gen and delay slots' two columns, in vocab order,
    which keeps the full path's tie-breaking)."""
    def full():
        logits = dense(hidden, text_head).float() / align_rows(s.text_temperature, 2)
        return _sample_text_full(keys, cfg, s, top_k_text, logits, is_audio, first_step, early)

    def cheap():
        lo, hi = sorted((cfg.audio_assistant_gen_slot_token_id,
                         cfg.audio_assistant_delay_slot_token_id))
        delay_col = (lo, hi).index(cfg.audio_assistant_delay_slot_token_id)
        # the two ids on the device by kernels alone (no upload: capture-safe)
        cols = torch.arange(2, device=hidden.device) * (hi - lo) + lo
        logits2 = _text_logits2(hidden, text_head, cols) / align_rows(s.text_temperature, 2)
        logits2 = torch.where(first_step[:, None] & (torch.arange(2, device=hidden.device)
                                                     == delay_col)[None], NEG_INF, logits2)
        choice = sample_topk_topp(keys, logits2, top_k=2, top_p=s.text_top_p,
                                  do_sample=s.text_do_sample)
        return cols[choice.long()].to(torch.int32)

    return full, cheap


def _sample_text_lazy(keys, cfg: DelayConfig, s: DelaySampling, top_k_text: int,
                      hidden: torch.Tensor,  # (B, D) the text head's source hidden
                      text_head, sampling_text, is_audio, first_step, early) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.delay._sample_text_lazy``: the text
    sample with the full-vocab head projected only when some row samples
    free text. Inside audio blocks the channel allows only the gen and
    delay slots, so when no row samples free text a 2-column projection
    replaces the full one (the same greedy tokens; the columns in vocab
    order keep the full path's tie-breaking). JAX decides behind a
    ``lax.cond``. Here the CPU decides on the host
    (``graph_loop.lazy_cond_plain``); the card by the condition kernel
    (``graph_loop.lazy_cond``), eagerly through a read of its decision,
    and inside a CUDA graph's capture as the handles of two IF nodes whose
    bodies are the two branches, each captured as a graph of its own on a
    side stream (``_lazy_in_capture``), so one graph serves both. JAX
    records a net loss for it on its own device, and no engine turns it
    on."""
    full, cheap = _lazy_branches(keys, cfg, s, top_k_text, hidden, text_head, is_audio,
                                 first_step, early)
    if hidden.device.type != "cuda":
        return full() if graph_loop.lazy_cond_plain(sampling_text, is_audio) else cheap()
    if torch.cuda.is_current_stream_capturing():
        return _lazy_in_capture(full, cheap, sampling_text, is_audio)
    _lazy_side_stream(hidden.device, (full, cheap))
    return full() if graph_loop.lazy_cond(sampling_text, is_audio) else cheap()


_LAZY_SIDE: dict = {}  # device -> the stream text_lazy's branch graphs are captured on


def _lazy_side_stream(device, branches=()) -> torch.cuda.Stream:
    """The side stream of ``device`` that ``_lazy_in_capture`` captures the
    branches on, made at the first eager lazy step, which first runs both
    ``branches`` on it (their cuBLAS workspace for the stream, which a
    capture cannot make)."""
    key = torch.device(device).index
    side = _LAZY_SIDE.get(key)
    if side is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("text_lazy: run a lazy step eagerly on the card before capturing "
                               "one (its branches' side stream is made then)")
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for branch in branches:
                branch()
        torch.cuda.current_stream(device).wait_stream(side)
        _LAZY_SIDE[key] = side
    return side


def _lazy_in_capture(full, cheap, sampling_text, is_audio) -> torch.Tensor:
    """JAX's ``lax.cond(need_full, full, cheap)`` inside a capture under way:
    each branch captured on the side stream as a graph of its own (one
    memory pool for the two: they never run together) that writes its
    tokens into one (B,) buffer, then the condition kernel and two IF
    nodes over them added to the capturing graph
    (``graph_loop.capture_lazy``), which keeps the branch graphs. A
    branch runs or not by the data, so its kernels' launches are taken
    back from the counts (``launches``); ``graph_loop.lazy_counts`` says
    how many times each branch ran."""
    dev = sampling_text.device
    side = _lazy_side_stream(dev)
    out = torch.empty(sampling_text.shape, dtype=torch.int32, device=dev)
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    before = launches.read()
    for branch in (full, cheap):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out.copy_(branch())
            finally:
                g.capture_end()
        graphs.append(g)
    launches.restore(before)
    graph_loop.capture_lazy(sampling_text, is_audio, *graphs)
    return out


def _delay_sample_and_update(
    state: DelayGenState, cfg: DelayConfig, s: DelaySampling,
    top_k_text: int, top_k_audio: int,
    text_logits: torch.Tensor,  # (B, V); or (B, D) hidden when text_head is given
    audio_logits: torch.Tensor,  # (B, n_vq, Va)
    text_head=None,
) -> DelayGenState:
    """Ports ``mosstts_tpu.models.delay._delay_sample_and_update``: one
    iteration of the delay state machine given this step's logits. With
    ``text_head``, ``text_logits`` is the head's source hidden state and
    the projection is deferred (``_sample_text_lazy``)."""
    B = text_logits.shape[0]
    n_vq = cfg.n_vq
    dev = text_logits.device

    # each row's key splits into its next key and the two draws' keys
    rng, k_text, k_audio = split_keys(state.rng, 3)
    audio_logits = audio_logits / align_rows(s.audio_temperature, 3)

    # ---- text channel ----
    (not_stop, forced_delay, forced_end, sampling_text, is_audio,
     first_step, early) = _text_preds(state, cfg)
    if text_head is not None:
        sampled_text = _sample_text_lazy(k_text, cfg, s, top_k_text, text_logits, text_head,
                                         sampling_text, is_audio, first_step, early)
    else:
        sampled_text = _sample_text_full(
            k_text, cfg, s, top_k_text, text_logits / align_rows(s.text_temperature, 2),
            is_audio, first_step, early)
    next_text = torch.full((B,), cfg.pad_token_id, dtype=torch.int32, device=dev)
    next_text = torch.where(sampling_text, sampled_text, next_text)
    next_text = torch.where(forced_delay, cfg.audio_assistant_delay_slot_token_id, next_text)
    next_text = torch.where(forced_end, cfg.audio_end_token_id, next_text).to(torch.int32)

    is_audio = is_audio | (next_text == cfg.audio_start_token_id)
    is_stopping = state.is_stopping | (next_text == cfg.im_end_token_id)

    # ---- audio channels ----
    ks = torch.arange(n_vq, dtype=torch.int32, device=dev)[None]
    pre_mask = state.audio_lengths[:, None] > ks
    post_mask = (ks > state.delayed[:, None] - 1) | (state.delayed[:, None] == SENTINEL)
    sampling_audio = pre_mask & post_mask  # (B, n_vq)

    rp_seen = torch.where(s.audio_rp_cross_batch, state.seen.any(dim=0, keepdim=True),
                          state.seen)
    audio_logits = apply_repetition_penalty_seen(audio_logits, rp_seen,
                                                 s.audio_repetition_penalty)
    sampled_audio = sample_topk_topp(k_audio, audio_logits, top_k=top_k_audio,
                                     top_p=s.audio_top_p, do_sample=s.audio_do_sample)
    next_audio = torch.where(sampling_audio, sampled_audio, cfg.audio_pad_code).to(torch.int32)

    # ---- counters (reference :505-509) ----
    starts_audio = ((next_text == cfg.audio_start_token_id)
                    | (next_text == cfg.audio_assistant_gen_slot_token_id)
                    | (next_text == cfg.audio_assistant_delay_slot_token_id))
    audio_lengths = state.audio_lengths + starts_audio.to(torch.int32)
    audio_lengths = torch.where(next_text == cfg.audio_end_token_id, 0, audio_lengths)
    delayed = torch.where(
        (state.delayed == SENTINEL) & (next_text == cfg.audio_assistant_delay_slot_token_id),
        0, state.delayed)
    delayed = torch.where(delayed != SENTINEL, delayed + 1, delayed)
    delayed = torch.where(delayed > n_vq, SENTINEL, delayed).to(torch.int32)

    seen = seen_mask_update(state.seen, next_audio, active=sampling_audio)

    frame = torch.cat([next_text[:, None], next_audio], dim=-1)  # (B, C)
    # per-row writes; steps past the out buffer drop (stopped rows idling)
    _set_rows_(state.out, state.step, frame)
    _set_rows_(state.out_valid, state.step, torch.ones((B,), dtype=torch.bool, device=dev))
    # the token just emitted is attendable iff its row has not stopped
    _set_rows_(state.kv_valid, state.pos, ~is_stopping)

    return state._replace(
        cur_ids=frame[:, None, :].to(state.cur_ids.dtype),
        step=state.step + 1,
        rng=rng,
        is_stopping=is_stopping,
        is_audio=is_audio,
        audio_lengths=audio_lengths.to(torch.int32),
        delayed=delayed,
        seen=seen,
    )


def delay_decode_step(
    params: DelayParams, cfg: DelayConfig, state: DelayGenState, sampling: DelaySampling,
    *, top_k_text: int = 50, top_k_audio: int = 25,
    attend_len: Optional[int] = None,
    uniform_slots: bool = False,
    hidden_out_layers: Optional[Sequence[int]] = None,
    text_lazy: bool = False,
) -> DelayGenState:
    """Ports ``mosstts_tpu.models.delay.delay_decode_step``: forward the
    pending frame, then run the state machine once. ``uniform_slots`` says
    every row's cache cursor is equal (the solo engine: one slice write at
    ``pos[0]``); by default each row writes at its own cursor ``pos[b]``, as
    the continuous-batching server needs. ``text_lazy`` projects the text
    head only when a row samples free text (``_sample_text_lazy``; a CUDA
    graph captures it with an IF node per branch)."""
    positions = state.pos[:, None]
    text_logits, audio_logits, cache = delay_forward(
        params, cfg, state.cur_ids, positions=positions, kv_valid=state.kv_valid,
        cache=state.cache, cache_offset=state.pos[0] if uniform_slots else state.pos,
        attend_len=attend_len, hidden_out_layers=hidden_out_layers, text_lazy=text_lazy,
    )
    state = state._replace(cache=cache, pos=state.pos + 1)
    return _delay_sample_and_update(state, cfg, sampling, top_k_text, top_k_audio,
                                    text_logits[:, -1], audio_logits[:, -1],
                                    text_head=params.text_head if text_lazy else None)


def ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy over the last axis with -100 ignored: (..., T, V)
    logits and (..., T) labels -> the sum over T of each row's negative
    log-likelihoods and its count of labels, both (...,)."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(-1), valid.sum(-1)


def delay_loss(
    params: DelayParams, cfg: DelayConfig,
    ids: torch.Tensor,  # (B, T, C)
    attention_mask: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T, C), -100 = ignore
    channelwise_loss_weight: Optional[torch.Tensor] = None,  # (C,)
    remat: bool = False,
    pipeline=None,
):
    """Ports ``mosstts_tpu.models.delay.delay_loss``: the
    multi-channel cross-entropy, summed per sample and channel and divided
    by the count of valid labels; with ``channelwise_loss_weight``, the
    weighted mean of the per-channel losses instead. Returns (loss,
    {"channel_losses" (C,), "token_counts" (C,)}). The pad code's logit is
    -inf (``delay_forward``), so a pad label would make the loss infinite:
    data never trains one (``train/data.py``). A data-parallel rank holds
    its block of the batch; the sums and counts are summed over ``"data"``
    (``pipeline``: the GPipe schedule of ``delay_forward``)."""
    B, T, C = ids.shape
    positions = torch.arange(T, dtype=torch.int32, device=ids.device)[None].expand(B, T)
    text_logits, audio_logits, _ = delay_forward(params, cfg, ids, positions=positions,
                                                 kv_valid=attention_mask.bool(), remat=remat,
                                                 pipeline=pipeline)
    s0, c0 = ce_sums(text_logits, labels[..., 0])  # (B,)
    sa, ca = ce_sums(audio_logits.transpose(1, 2), labels[..., 1:].transpose(1, 2))  # (B, n_vq)
    all_sum = torch.cat([s0[:, None], sa], dim=1)  # (B, C)
    all_cnt = torch.cat([c0[:, None], ca], dim=1)
    dp = axis_of(params, "data")
    sums, counts = reduce(all_sum.sum(0), dp), reduce(all_cnt.sum(0), dp)  # (C,)
    ch_loss = sums / counts.float().clamp(min=1.0)
    if channelwise_loss_weight is not None:
        w = torch.as_tensor(channelwise_loss_weight, dtype=torch.float32, device=ids.device)
        loss = (ch_loss * w).sum() / w.sum()
    else:
        loss = (reduce(all_sum.sum(), dp)
                / reduce(all_cnt.sum(), dp).float().clamp(min=1.0))
    return loss, {"channel_losses": ch_loss, "token_counts": counts}


def delay_train_step(params: DelayParams, cfg: DelayConfig, batch, lr: float = 1e-4):
    """Ports ``mosstts_tpu.models.delay.delay_train_step``: one SGD step
    ``p - lr * g`` over ``delay_loss``, in place. Returns (params, loss,
    aux)."""
    from ..train.optim import value_and_grad

    loss, aux, grads = value_and_grad(params, lambda p: delay_loss(
        p, cfg, batch["input_ids"], batch["attention_mask"], batch["labels"]))
    dp = axis_of(params, "data")  # a data-parallel rank's rows: the shares summed
    grads = {k: reduce(g, dp) for k, g in grads.items()}
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.sub_(lr * grads[name].to(p.dtype))
    return params, loss, aux


def delay_decode_until_event(
    steps, watch, budget_left, max_steps: int, *, top_k_text: int = 50,
    top_k_audio: int = 25, attend_len: Optional[int] = None, uniform_slots: bool = False,
    hidden_out_layers: Optional[Sequence[int]] = None,
) -> Tuple[DelayGenState, int, np.ndarray]:
    """Ports ``mosstts_tpu.models.delay.delay_decode_until_event``: decode
    until a scheduling event, a watched row that stopped (EOS) or used up
    its budget, or ``max_steps`` steps. ``steps`` is an
    ``engine.step_graph.DecodeSteps`` whose state advances in place;
    ``watch`` (B,) bool and ``budget_left`` (B,) int are host arrays.
    Returns ``(state, executed, flags)``: the steps run (JAX's loop
    counter), which the caller's host mirrors of ``pos`` and ``step``
    advance by, and the stop flags after them on the host.

    The condition ``i < max_steps & ~any(watch & (is_stopping | i >=
    budget_left))`` is JAX's ``while_loop`` condition, read after every
    step: on the CPU by the host after each eager step, on the card by a
    condition kernel inside one graph launch (``step_graph.DeviceLoop``),
    so the loop stops after the very step at which the event holds."""
    kw = dict(attend_len=attend_len, uniform_slots=uniform_slots, top_k_text=top_k_text,
              top_k_audio=top_k_audio, hidden_out_layers=hidden_out_layers)
    executed, flags = steps.loop_event(np.asarray(watch, bool), np.asarray(budget_left, np.int64),
                                       max(int(max_steps), 0), **kw)
    return steps.state, executed, flags


def delay_generate_on_device(
    steps, *, max_new_tokens: int, top_k_text: int = 50, top_k_audio: int = 25,
    attend_len: Optional[int] = None, uniform_slots: bool = False,
    hidden_out_layers: Optional[Sequence[int]] = None,
) -> Tuple[DelayGenState, int, np.ndarray]:
    """Ports ``mosstts_tpu.models.delay.delay_generate_on_device``: decode
    while ``min(step) < max_new_tokens`` and some row has not stopped, JAX's
    ``lax.while_loop``, the condition read after every step (on the card by
    a condition kernel inside one graph launch). ``steps`` is an
    ``engine.step_graph.DecodeSteps``: the parameters, config, sampling and
    the state, which advances in place, are its own. Returns ``(state,
    executed, flags)``: the steps run and the stop flags after them on the
    host."""
    kw = dict(attend_len=attend_len, uniform_slots=uniform_slots, top_k_text=top_k_text,
              top_k_audio=top_k_audio, hidden_out_layers=hidden_out_layers)
    executed, flags = steps.loop_generate(int(max_new_tokens), **kw)
    return steps.state, executed, flags
