"""MossTTSDelay: the multi-head RVQ transformer with delay-pattern decoding.

Ports ``mosstts_tpu/models/delay.py``: ``init_delay_params``,
``delay_embed``, ``_audio_head_logits``, ``delay_forward`` (no
``hidden_out_layers``, no pipeline), ``DelaySampling``/``make_sampling``,
``DelayGenState``, ``delay_prefill``, ``_text_preds``,
``_sample_text_full``, ``_delay_sample_and_update`` and
``delay_decode_step``. The 32 audio tables and 33 heads stay stacked
(``(n_vq, Va, D)`` and ``(n_vq, D, Va)``) so the embedding sum and the head
projection are one gather and one batched product. The heads may be int8
``QuantWeight``s (``ops/quant.py``, ``DelayEngine.quantize``): the text head
goes through ``dense``, the audio stack through one W8A16 launch.

State updates follow the JAX package's order: ``kv_valid[pos]`` is set by
the sampler, before the next forward writes K/V at ``pos``; ``pos``
advances in the forward. Writes at ``step``/``pos`` past the end of their
buffer are dropped, as JAX's ``mode="drop"`` does, by masking. The cache,
``out``, ``out_valid`` and ``kv_valid`` are updated in place.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch
from torch import nn

from ..core.config import DelayConfig
from ..nn.qwen3 import (Qwen3Params, empty_param, fill_qwen3_params_, init_kv_cache,
                        init_quant_kv_cache, qwen3_forward)
from ..ops.basic import dense, put_drop_
from ..ops.kernels import w8_gemm
from ..ops.quant import is_quantized
from ..ops.sampling import (
    align_rows,
    apply_repetition_penalty_seen,
    find_last_equal,
    sample_topk_topp,
    seen_mask_update,
)

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


def delay_embed(params: DelayParams, cfg: DelayConfig, ids: torch.Tensor) -> torch.Tensor:
    """Ports ``mosstts_tpu.models.delay.delay_embed``: ids (B, T, 1+n_vq) ->
    summed embeddings (B, T, D). Channel 0 uses the text embedding, channels
    1..n_vq the stacked audio tables."""
    Va = cfg.audio_emb_vocab
    emb = params.backbone.embed[ids[..., 0].long()]
    flat = params.audio_emb.reshape(cfg.n_vq * Va, -1)
    offs = torch.arange(cfg.n_vq, device=ids.device) * Va
    audio = flat[ids[..., 1:].long() + offs]  # (B, T, n_vq, D)
    return emb + audio.to(emb.dtype).sum(dim=-2)


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
    * float32 heads, and bf16 heads on the CPU: the product in float32."""
    if is_quantized(heads):
        return w8_gemm.w8a16_gemm(hidden.contiguous(), heads.q, heads.scale, torch.float32)
    B, T, D = hidden.shape
    n, V = heads.shape[0], heads.shape[2]
    x = hidden.reshape(B * T, D)
    if x.device.type == "cuda" and heads.dtype != torch.float32:
        logits = torch.bmm(x.expand(n, B * T, D), heads, out_dtype=torch.float32)
    else:
        logits = torch.matmul(x.float(), heads.float())  # (n, B*T, V)
    return logits.permute(1, 0, 2).reshape(B, T, n, V)


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
    logits_len: Optional[int] = None,
):
    """Ports ``mosstts_tpu.models.delay.delay_forward``. Returns
    (text_logits (B, T, V) f32, audio_logits (B, T, n_vq, Va) f32, cache);
    the last audio vocab column (the pad code) is masked to NEG_INF.
    ``logits_len`` keeps only the last positions for the heads."""
    embeds = delay_embed(params, cfg, ids)
    hidden, cache = qwen3_forward(
        params.backbone, cfg.language_config, embeds,
        positions=positions, kv_valid=kv_valid, cache=cache, cache_offset=cache_offset,
        attend_len=attend_len,
    )
    if logits_len is not None:
        hidden = hidden[:, -logits_len:]
    text_logits = dense(hidden, params.text_head).float()
    audio_logits = _audio_head_logits(hidden, params.audio_heads)
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
    ``torch.Generator`` per row."""

    cache: Any  # KVCache | QuantKVCache | PagedKVCache | QuantPagedKVCache
    kv_valid: torch.Tensor  # (B, S) bool
    cur_ids: torch.Tensor  # (B, 1, C) token to feed next forward
    pos: torch.Tensor  # (B,) int32 cache slot where cur_ids will be written
    step: torch.Tensor  # (B,) int32 per-row decode step counter
    rng: List[torch.Generator]
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
    rng: List[torch.Generator],
    sampling: DelaySampling,
    top_k_text: int = 50,
    top_k_audio: int = 25,
    dtype=torch.bfloat16,
    kv_quant: bool = False,
) -> DelayGenState:
    """Ports ``mosstts_tpu.models.delay.delay_prefill``: run the prompt into
    a fresh linear cache (int8 with per-slot scales when ``kv_quant``; the
    prompt then attends its own k/v and only the cache write is quantized),
    then sample the first frame from its last position. ``rng`` is one
    generator per row."""
    B, T, C = input_ids.shape
    n_vq, Va = cfg.n_vq, cfg.audio_emb_vocab
    dev = input_ids.device
    if len(rng) != B:
        raise ValueError(f"need one generator per row: {len(rng)} for batch {B}")

    cache = (init_quant_kv_cache(cfg.language_config, B, cache_len, device=dev) if kv_quant
             else init_kv_cache(cfg.language_config, B, cache_len, dtype=dtype, device=dev))
    kv_valid = torch.zeros((B, cache_len), dtype=torch.bool, device=dev)
    kv_valid[:, :T] = attention_mask
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)

    text_logits, audio_logits, cache = delay_forward(
        params, cfg, input_ids, positions=positions, kv_valid=kv_valid,
        cache=cache, cache_offset=0, logits_len=1,
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
        rng=list(rng),
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


def _sample_text_full(gens, cfg: DelayConfig, s: DelaySampling, top_k_text: int,
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
    return sample_topk_topp(gens, text_logits, top_k=top_k_text, top_p=s.text_top_p,
                            do_sample=s.text_do_sample)


def _delay_sample_and_update(
    state: DelayGenState, cfg: DelayConfig, s: DelaySampling,
    top_k_text: int, top_k_audio: int,
    text_logits: torch.Tensor,  # (B, V)
    audio_logits: torch.Tensor,  # (B, n_vq, Va)
) -> DelayGenState:
    """Ports ``mosstts_tpu.models.delay._delay_sample_and_update``: one
    iteration of the delay state machine given this step's logits."""
    B = text_logits.shape[0]
    n_vq = cfg.n_vq
    dev = text_logits.device

    audio_logits = audio_logits / align_rows(s.audio_temperature, 3)

    # ---- text channel ----
    (not_stop, forced_delay, forced_end, sampling_text, is_audio,
     first_step, early) = _text_preds(state, cfg)
    sampled_text = _sample_text_full(
        state.rng, cfg, s, top_k_text, text_logits / align_rows(s.text_temperature, 2),
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
    sampled_audio = sample_topk_topp(state.rng, audio_logits, top_k=top_k_audio,
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
) -> DelayGenState:
    """Ports ``mosstts_tpu.models.delay.delay_decode_step``: forward the
    pending frame, then run the state machine once. ``uniform_slots`` says
    every row's cache cursor is equal (the solo engine: one slice write at
    ``pos[0]``); by default each row writes at its own cursor ``pos[b]``, as
    the continuous-batching server needs."""
    positions = state.pos[:, None]
    text_logits, audio_logits, cache = delay_forward(
        params, cfg, state.cur_ids, positions=positions, kv_valid=state.kv_valid,
        cache=state.cache, cache_offset=state.pos[0] if uniform_slots else state.pos,
        attend_len=attend_len,
    )
    state = state._replace(cache=cache, pos=state.pos + 1)
    return _delay_sample_and_update(state, cfg, sampling, top_k_text, top_k_audio,
                                    text_logits[:, -1], audio_logits[:, -1])
