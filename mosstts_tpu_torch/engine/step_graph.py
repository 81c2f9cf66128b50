"""Decode steps and prefills of the three families over static buffers,
replayed as CUDA graphs on the card.

The port's counterpart of the JAX package's compiled step and prefill
programs: ``jax.jit`` of ``delay_decode_step`` with the state donated
(``mosstts_tpu/engine/delay_engine.py:125``, ``batch_server.py:398``), of
``delay_prefill`` (``delay_engine.py:110``, ``batch_server.py:262``), of
``realtime_decode_step`` (``realtime_engine.py:159``,
``realtime_batch_server.py:186``), of ``realtime_prefill_step``
(``realtime_engine.py:147``, and inside ``realtime_batch_server.py:161``'s
``_admit_fn``), and of ``local_prefill_split`` (``local_engine.py:58``,
``local_batch_server.py:137``). ``GraphSteps`` holds what they share:
the capture stream and pool, the warm-up and capture of a key, the replay
and its launch accounting, the check that the weights are still the
ones captured.

``RealtimeSteps`` does for a ``RealtimeState`` what ``DecodeSteps`` (below)
does for a ``DelayGenState``: one graph per ``(attend_len, top_k,
per_row)`` of a whole frame (the backbone step, the unrolled depth loop,
the samplings), fed from a static (B,) text-token buffer. ``LocalSteps``
does the same for a ``LocalGenState`` (JAX ``local_engine.py:74``,
``local_batch_server.py:156``): one graph per ``(attend_len, n_vq_infer,
eos_token_id, per_row)`` of ``local_frame_step``, its depth loop over the
channels unrolled.

``DecodeSteps`` owns one ``DelayGenState`` and one ``DelaySampling`` whose
tensors never move, and advances the state in place, one decode step per
``step()``. On the card a step is the replay of a CUDA graph of one
``delay_decode_step``, one graph per ``(attend_len, uniform_slots,
top_k_text, top_k_audio, hidden_out_layers)``. The graph ends by copying
every field the step replaces (``STEP_FIELDS``) back into its buffer, as a
donated JAX buffer is reused; the cache, ``kv_valid``, ``out`` and
``out_valid`` are written in place by the step itself.

``DeviceLoop`` runs JAX's device-resident loops (its ``lax.while_loop``
and ``fori_loop`` programs): a decode until every row stops
(``delay_generate_on_device``), until a scheduling event (the servers'
``_event_fn``), or k steps (``_block_fn``), each as one launch of a CUDA
graph with a conditional WHILE node over the step graph, whose condition a
kernel evaluates on the card after every step (``ops/kernels/graph_loop``).
The host writes the loop's limits before the launch and reads the counters
and stop flags back once after it. One executable graph per (loop kind,
step key) is kept for the owner's life. On the CPU, and with graphs off, the
same loop runs eagerly and evaluates the same condition after every step,
which is JAX's ``while_loop`` exactly.

``Prefills`` prefills prompts into a static state (the engine's decode
state, or the server's batch-1 admission state) with its static sampling:
one CUDA graph of ``delay_prefill`` and ``copy_state_`` per ``(T,
top_k_text, top_k_audio, hidden_out_layers)``, the prompt's exact length
(no padding to a bucket: a padded prompt rounds differently), over static
prompt and mask buffers of that length. ``RealtimePrefills`` (per ``(T,
attend_len, top_k)``) and ``LocalPrefills`` (per ``(T, n_vq_infer)``) do
the same for the other two families, on ``PrefillGraphs``, the machinery
the three share. A server's program ends, in the same graph, with its
splice of the prefilled state into the slots (``after``: JAX's
``_insert_fn``, ``_admit_fn``), at control words on the card, so one graph
serves every slot. A key's first prefill runs
eagerly; the second captures the graph and replays it, and so does every
later one (``capture()`` captures ahead, for a server's ``warmup()``). So
a prompt length seen once costs what an eager prefill costs, and the graphs
pay only where lengths repeat: the Delay server's prompt buckets (at most
``cache_len / prompt_bucket`` of them, so it keeps every graph, as JAX's
compile cache keeps every program), or an engine's repeated exact lengths
(the engine keeps ``max_graphs``, the least recently used dropped first).
The Realtime and Local servers capture only ahead (``capture_on_use``
False): a prompt bucket their ``warmup()`` did not name runs eagerly at
every admission instead of stalling every slot's frames for a capture.
``counts`` tells how the runs went: eager, captured, or replayed.

The first step at a key, and a key's first prefill, run eagerly on the
capture stream: they are real work, and they build the kernels, set their
shared-memory limits and make cuBLAS's handle and workspace, none of which
a capture may do. Then the graph is captured (a capture runs nothing) and
later calls at that key replay it. The sampling keys are state tensors
(``ops/sampling.py``): a graph reads and splits them on the card, so a
replay, or a loop's iteration, draws from the keys the state holds then,
and writing a key row between replays takes effect at the next one. No
graph registers a ``torch.Generator``. A ``Prefills``
shares its ``DecodeSteps``' capture stream and memory pool: nothing a
capture allocates is read after its graph ends, so the graphs may replay in
any order, one at a time. A failed capture or replay raises; nothing falls
back to eager work. The launch counts a capture made are taken back and
added per replay (``ops/kernels/launches.py``).

With ``graphs=False``, and always for CPU tensors, each step and prefill
runs eagerly and copies its fields back the same way, so the two paths
share everything but how the kernels are issued.

``CodecChunks`` does the same for the codec's chunk programs (JAX's
``MossAudioTokenizer._encode_fn`` and ``_decode_fn``, ``codec/model.py:226,
236``): one graph per ``(kind, B, chunk frames, levels, weights)`` over
static chunk, ``valid_len`` and stream-state buffers, each graph in a
memory pool of its own, the codec's parameters checked (and the graphs
dropped when they were replaced) at every call.

Every tensor a graph reads must outlive it at the same address: the
weights (``quantize()`` replaces them, so an owner drops its
``DecodeSteps`` and ``Prefills`` then), the state, prompt and sampling
buffers, and the paged table. ``step()`` and ``run()`` raise if the
parameters' text head is no longer the one they were built with.

Captures may happen while other threads use the card: the serving pool's
decode thread captures a new attend bucket or prompt length while HTTP
handler threads run the codec or a solo engine. So a capture runs in CUDA's
thread-local capture mode, in which only the capturing thread is barred
from calls a capture forbids, and captures are serialised process-wide
(``_CAPTURE_LOCK``): ``torch.cuda.graph`` synchronises the device and
empties the allocator's cache before it begins, which would break a
capture under way in another thread. Other threads must not synchronise
the whole device while a capture may run; a stream's or an event's
synchronisation is fine.
"""
from __future__ import annotations

import functools
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ..codec.model import _decode_chunk, _encode_chunk, _txf_cfg
from ..codec.transformer import init_stream_state
from ..core.config import DelayConfig, RealtimeConfig
from ..models.delay import (DelayGenState, DelayParams, DelaySampling, delay_decode_step,
                            delay_prefill)
from ..models.local import (LocalGenState, LocalParams, LocalSampling, copy_local_state_,
                            local_frame_step, local_prefill_split)
from ..models.realtime import (RealtimeParams, RealtimeSampling, RealtimeState,
                               realtime_decode_step, realtime_prefill_step)
from ..nn.qwen3 import init_kv_cache, init_quant_kv_cache
from ..ops.kernels import graph_loop, launches
from ..ops.quant import is_quantized

# one capture at a time in the process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()

# the DelayGenState fields delay_decode_step returns as new tensors
STEP_FIELDS = ("cur_ids", "pos", "step", "rng", "is_stopping", "is_audio", "audio_lengths",
               "delayed", "seen")
# the RealtimeState fields realtime_decode_step returns as new tensors
RT_STEP_FIELDS = ("cur_len", "last_audio", "is_stopping", "hist_len", "rng")
# the LocalGenState fields local_frame_step returns as new tensors
LOCAL_STEP_FIELDS = ("cur_ids", "pos", "step", "unfinished", "rng")


def host_tensor(x, device) -> torch.Tensor:
    """``x`` (an array) as a CPU tensor to copy to ``device``: pinned for a
    CUDA device, so the copy waits neither for the device nor the host."""
    t = torch.as_tensor(np.asarray(x))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def zero_state(cfg: DelayConfig, B: int, cache_len: int, out_len: int, *, dtype,
               kv_quant: bool, device) -> DelayGenState:
    """A static state of ``B`` rows, zeros everywhere (the keys too): a
    linear KV cache of ``cache_len`` slots in ``dtype`` (int8 with scales
    when ``kv_quant``) and ``out_len`` output steps."""
    lc, C = cfg.language_config, cfg.channels

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return DelayGenState(
        cache=(init_quant_kv_cache(lc, B, cache_len, device=device) if kv_quant else
               init_kv_cache(lc, B, cache_len, dtype=dtype, device=device)),
        kv_valid=zeros((B, cache_len), torch.bool),
        cur_ids=zeros((B, 1, C), torch.int64),
        pos=zeros((B,), torch.int32), step=zeros((B,), torch.int32), rng=zeros((B, 2), torch.int64),
        is_stopping=zeros((B,), torch.bool), is_audio=zeros((B,), torch.bool),
        audio_lengths=zeros((B,), torch.int32), delayed=zeros((B,), torch.int32),
        seen=zeros((B, cfg.n_vq, cfg.audio_emb_vocab), torch.bool),
        out=zeros((B, out_len, C), torch.int32),
        out_valid=zeros((B, out_len), torch.bool))


def copy_state_(dst: DelayGenState, src: DelayGenState) -> None:
    """Copy ``src`` (a prefill's state) into the static ``dst`` in place; a
    cache the prefill already wrote in place (``delay_prefill(cache=...)``)
    is not copied. ``dst.out``/``out_valid`` may hold more steps than
    ``src``'s: the rest is zeroed."""
    for d, s in zip(dst.cache, src.cache):
        if d is not s:
            d.copy_(s)
    for name in ("kv_valid",) + STEP_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))
    for name in ("out", "out_valid"):
        d, s = getattr(dst, name), getattr(src, name)
        d[:, :s.shape[1]].copy_(s)
        d[:, s.shape[1]:].zero_()


class GraphSteps:
    """What every static-state program over ``params`` shares: the capture
    stream and memory pool of its graphs, the warm-up and capture of a key,
    the replay with its launch accounting, and the check that ``params``
    still holds the weights the graphs read (``marker``, a parameter that
    ``quantize()`` replaces). ``graphs`` replays CUDA graphs when
    ``device`` is a CUDA device."""

    def __init__(self, params, marker, device, *, graphs: bool = True):
        self.params = params
        self.graphs = graphs and torch.device(device).type == "cuda"
        self.pool = None  # the graphs' memory pool, made at the first capture
        self._marker_name = marker
        self._marker = getattr(params, marker)
        self._device = device
        self._stream: Optional[torch.cuda.Stream] = None
        self._captured = {}  # key -> (CUDAGraph, the launches its capture counted)
        self._loop: Optional["DeviceLoop"] = None

    @property
    def keys(self):
        """The keys captured so far."""
        return tuple(self._captured)

    def check_params(self) -> None:
        if getattr(self.params, self._marker_name) is not self._marker:
            raise RuntimeError("the parameters were replaced since these decode steps were "
                               "built (quantize()?): build new ones")

    def warm(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` eagerly: on the capture stream when graphs are on (the
        warm-up of a key, whose kernels and cuBLAS workspace the capture
        then finds made), else where the caller runs."""
        if not self.graphs:
            fn()
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
            self.pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            fn()
        torch.cuda.current_stream().wait_stream(self._stream)

    def capture(self, fn: Callable[[], None], pool=None) -> tuple:
        """Capture ``fn`` (warmed up by ``warm``) into a graph in this
        object's pool, or in ``pool`` when given. Returns the graph, which
        keeps its ``cudaGraph_t`` (``raw_cuda_graph()``, the body a
        ``DeviceLoop`` clones), and the launches its capture counted, which
        are taken back from the counts (a replay adds them)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _CAPTURE_LOCK:
            before = launches.read()
            graph_loop.take_held()
            try:
                with torch.cuda.graph(graph, pool=self.pool if pool is None else pool,
                                      stream=self._stream,
                                      capture_error_mode="thread_local"):
                    fn()
            finally:
                captured = launches.since(before)
                launches.restore(before)
                # the graphs a lazy step's conditional nodes cloned read
                # their own pools: they live as long as this graph
                graph.held = graph_loop.take_held()
        return graph, captured

    def run_key(self, key, fn: Callable[[], None]) -> None:
        """``fn`` at ``key``: the replay of its graph if one was captured;
        else ``fn`` run eagerly (``warm``), then, with graphs on, captured
        for the key's later calls."""
        self.check_params()
        entry = self._captured.get(key)
        if entry is not None:
            entry[0].replay()
            launches.add_replay(entry[1])
            return
        self.warm(fn)  # a real step
        if self.graphs:
            self._captured[key] = self.capture(fn)

    def _step_at(self, key) -> None:
        """One step at ``key`` (``_eager``, the subclass's), replayed or run
        eagerly (``run_key``)."""
        self.run_key(key, lambda: self._eager(key))

    def loop(self, kind: int, key, *, limit: int,
             flags: Optional[torch.Tensor] = None, invert: bool = False,
             step: Optional[torch.Tensor] = None, watch=None, budget=None,
             feed: Optional[tuple] = None):
        """JAX's loop of the step at ``key`` as one device program
        (``DeviceLoop.run``)."""
        if self._loop is None:
            self._loop = DeviceLoop(self._device)
        return self._loop.run(self, kind, key, limit=limit, flags=flags, invert=invert,
                              step=step, watch=watch, budget=budget, feed=feed)


class DecodeSteps(GraphSteps):
    """Decode steps of ``params`` over the static ``state`` and ``sampling``.
    ``graphs`` replays CUDA graphs for CUDA tensors."""

    def __init__(self, params: DelayParams, cfg: DelayConfig, state: DelayGenState,
                 sampling: DelaySampling, *, graphs: bool = True):
        super().__init__(params, "text_head", state.pos.device, graphs=graphs)
        self.cfg, self.state, self.sampling = cfg, state, sampling
        # the stop flags the loops read: the state's own, or, for a
        # data-parallel engine, every rank's rows, which ``sync`` gathers at
        # the end of each step (inside its graph)
        self.flags = state.is_stopping
        self.sync: Optional[Callable[[], None]] = None

    @staticmethod
    def _key(attend_len, uniform_slots, top_k_text, top_k_audio, hidden_out_layers=None) -> tuple:
        return (attend_len, uniform_slots, top_k_text, top_k_audio,
                None if hidden_out_layers is None else tuple(hidden_out_layers))

    @torch.no_grad()
    def step(self, *, attend_len: Optional[int], uniform_slots: bool, top_k_text: int,
             top_k_audio: int, hidden_out_layers: Optional[tuple] = None) -> None:
        """One decode step of the whole batch, in place."""
        self._step_at(self._key(attend_len, uniform_slots, top_k_text, top_k_audio,
                                hidden_out_layers))

    @torch.no_grad()
    def loop_generate(self, max_new_tokens: int, **kw):
        """Steps while ``min(step) < max_new_tokens`` and some row has not
        stopped (JAX's ``delay_generate_on_device``): ``(executed, flags)``."""
        return self.loop(graph_loop.GENERATE, self._key(**kw), limit=max_new_tokens,
                         flags=self.flags, step=self.state.step)

    @torch.no_grad()
    def loop_event(self, watch: np.ndarray, budget_left: np.ndarray, max_steps: int, **kw):
        """Steps until a watched row stops or reaches its budget, or
        ``max_steps`` (JAX's ``delay_decode_until_event``): ``(executed,
        flags)``."""
        return self.loop(graph_loop.EVENT, self._key(**kw), limit=max_steps, flags=self.flags,
                         watch=watch, budget=budget_left)

    @torch.no_grad()
    def loop_block(self, k: int, **kw) -> None:
        """``k`` steps as one launch, nothing read back (JAX's ``_block_fn``)."""
        self.loop(graph_loop.BLOCK, self._key(**kw), limit=k)

    def _eager(self, key) -> None:
        attend_len, uniform_slots, top_k_text, top_k_audio, hol = key
        new = delay_decode_step(self.params, self.cfg, self.state, self.sampling,
                                top_k_text=top_k_text, top_k_audio=top_k_audio,
                                attend_len=attend_len, uniform_slots=uniform_slots,
                                hidden_out_layers=hol)
        for name in STEP_FIELDS:
            getattr(self.state, name).copy_(getattr(new, name))
        if self.sync is not None:
            self.sync()


class RealtimeSteps(GraphSteps):
    """Realtime frames (``models.realtime.realtime_decode_step``) of
    ``params`` over the static ``state`` (a scalar cursor for the engine,
    (B,) cursors for the server) and ``sampling``, with a static (B,) text
    token buffer, ``tokens``. On the card a frame is the replay of a CUDA
    graph per ``(attend_len, top_k, per_row)``, which copies back the fields
    the step replaces (``RT_STEP_FIELDS``); ``kv_valid``, ``history`` and
    the cache are written in place by the step."""

    def __init__(self, params: RealtimeParams, cfg: RealtimeConfig, state: RealtimeState,
                 sampling: RealtimeSampling, *, graphs: bool = True):
        super().__init__(params, "local_heads", state.is_stopping.device, graphs=graphs)
        self.cfg, self.state, self.sampling = cfg, state, sampling
        self.tokens = torch.full(state.is_stopping.shape, cfg.text_pad, dtype=torch.int64,
                                 device=state.is_stopping.device)

    @torch.no_grad()
    def step(self, tokens: Optional[torch.Tensor] = None, *, attend_len: Optional[int],
             top_k: int) -> None:
        """One frame of the whole batch, in place, feeding ``tokens`` (B,)
        (on the host, pinned, or on the device), else what ``self.tokens``
        holds."""
        if tokens is not None:
            self.tokens.copy_(tokens, non_blocking=True)
        self._step_at((attend_len, top_k, self.state.cur_len.ndim == 1))

    @torch.no_grad()
    def loop_event(self, staged: torch.Tensor, watch: np.ndarray, budget_left: np.ndarray,
                   max_steps: int, *, attend_len: Optional[int], top_k: int):
        """Frames until a watched row stops or reaches its budget, or
        ``max_steps`` (the JAX server's ``_event_fn``), frame i fed column
        i of ``staged`` (B, K) on the device: ``(executed, flags)``."""
        return self.loop(graph_loop.EVENT, (attend_len, top_k, self.state.cur_len.ndim == 1),
                         limit=max_steps, flags=self.state.is_stopping, watch=watch,
                         budget=budget_left, feed=(staged, self.tokens))

    def _eager(self, key) -> None:
        attend_len, top_k, _ = key
        new, _ = realtime_decode_step(self.params, self.cfg, self.state, self.tokens,
                                      self.sampling, top_k=top_k, attend_len=attend_len)
        copy_rt_fields_(self.state, new)


class LocalSteps(GraphSteps):
    """Local frames (``models.local.local_frame_step``) of ``params`` over
    the static ``state`` (a scalar cursor for the engine, (B,) cursors for
    the server) and the static per-channel ``sampling``. On the card a frame
    is the replay of a CUDA graph per ``(attend_len, n_vq_infer,
    eos_token_id, per_row)``, which copies back the fields the step
    replaces (``LOCAL_STEP_FIELDS``); the caches, ``kv_valid``, the seen
    masks and ``out`` are written in place by the step."""

    def __init__(self, params: LocalParams, cfg, state: LocalGenState,
                 sampling: LocalSampling, *, graphs: bool = True):
        super().__init__(params, "text_head", state.unfinished.device, graphs=graphs)
        self.cfg, self.state, self.sampling = cfg, state, sampling

    def _key(self, attend_len, n_vq_infer, eos_token_id) -> tuple:
        return (attend_len, n_vq_infer, eos_token_id, self.state.pos.ndim == 1)

    @torch.no_grad()
    def step(self, *, attend_len: Optional[int], n_vq_infer: int, eos_token_id: int) -> None:
        """One frame of the whole batch, in place."""
        self._step_at(self._key(attend_len, n_vq_infer, eos_token_id))

    @torch.no_grad()
    def loop_event(self, watch: np.ndarray, budget_left: np.ndarray, max_steps: int, **kw):
        """Frames until a watched row finishes or reaches its budget, or
        ``max_steps`` (the JAX server's ``_event_fn``): ``(executed,
        flags)``, the flags ``unfinished``."""
        return self.loop(graph_loop.EVENT, self._key(**kw), limit=max_steps,
                         flags=self.state.unfinished, invert=True, watch=watch,
                         budget=budget_left)

    @torch.no_grad()
    def loop_block(self, k: int, **kw) -> None:
        """``k`` frames as one launch, nothing read back (JAX's ``_block_fn``)."""
        self.loop(graph_loop.BLOCK, self._key(**kw), limit=k)

    def _eager(self, key) -> None:
        attend_len, n_vq_infer, eos_token_id, _ = key
        new = local_frame_step(self.params, self.cfg, self.state, self.sampling,
                               n_vq_infer=n_vq_infer, eos_token_id=eos_token_id,
                               attend_len=attend_len)
        for name in LOCAL_STEP_FIELDS:
            getattr(self.state, name).copy_(getattr(new, name))


class DeviceLoop:
    """JAX's device-resident loops over one ``GraphSteps``' step graphs (the
    owner holds its ``DeviceLoop``, and passes itself to ``run``).

    ``run`` runs the owner's step at ``key`` (in place) while the loop's
    condition holds (``ops.kernels.graph_loop.loop_cond_plain`` says which
    condition each kind has), and returns ``(executed, flags)``: the steps
    run and the stop flags on the host (None for a block, which reads
    nothing back). On the
    card the whole loop is one launch of an executable graph per ``(kind,
    key)``, built at the key's first loop from the step graph
    (``graph_loop.build_loop``): the host copies the limits into the
    control words, launches it, and, but for a block, copies the counters and
    the flags back behind it and waits once. A key whose step graph is not
    captured yet runs its first step eagerly, then captures it, after the host checked the condition, and the graph loop
    carries on from step 1. The launch counts add the step graph's captured
    launches once per step run, and the control kernels' runs.

    On the CPU, and with graphs off, the loop is eager: the condition is
    evaluated after every step by its plain version, as JAX's
    ``while_loop`` does."""

    def __init__(self, device):
        self.device = device  # no reference to the owner: its graphs go with it
        self.ctrl = torch.zeros(graph_loop.CTRL_WORDS, dtype=torch.int32, device=self.device)
        self._rows = None  # (2, B) int32: the event loop's watch and budget rows
        self._execs = {}  # (kind, key) -> executable graph
        self.launches = 0  # loop graph launches

    def __del__(self):
        graph_loop.release(getattr(self, "_execs", {}))

    def run(self, owner: GraphSteps, kind: int, key, *, limit: int, flags=None,
            invert: bool = False, step=None, watch=None, budget=None, feed=None):
        owner.check_params()
        read = kind != graph_loop.BLOCK  # a block runs a fixed count and reads nothing
        fn = functools.partial(owner._step_at, key)
        rows = None
        if watch is not None:  # the watch and budget rows, int32 on the host
            rows = np.stack([np.asarray(watch, bool),
                             np.clip(np.asarray(budget, np.int64), -(1 << 30), 1 << 30)]
                            ).astype(np.int32)

        def holds(i: int) -> bool:  # the condition's plain version, on the host
            return graph_loop.loop_cond_plain(
                kind, i, limit, flags=None if flags is None else flags.cpu(), invert=invert,
                step=None if step is None else step.cpu(),
                watch=None if rows is None else torch.from_numpy(rows[0]).bool(),
                budget=None if rows is None else torch.from_numpy(rows[1]))

        def fed(i: int) -> None:
            if feed is not None:
                feed[1].copy_(feed[0][:, i])

        i = 0
        if not owner.graphs:  # JAX's while_loop, eagerly
            while holds(i):
                fed(i)
                fn()
                i += 1
            return i, (flags.cpu().numpy() if read and flags is not None else None)
        if key not in owner._captured:  # the key's first step: eager, then captured
            if not holds(0):
                return 0, flags.cpu().numpy() if read and flags is not None else None
            fed(0)
            fn()
            i = 1
        ex = self._exec(owner, kind, key, dict(flags=flags, invert=invert, step=step,
                                               rows=rows is not None), feed)
        host = np.zeros(graph_loop.CTRL_WORDS, np.int32)
        host[graph_loop.I], host[graph_loop.LIMIT] = i, limit
        self.ctrl.copy_(host_tensor(host, self.device), non_blocking=True)
        if rows is not None:
            self._rows.copy_(host_tensor(rows, self.device), non_blocking=True)
        graph_loop.launch(ex, self.device)
        self.launches += 1
        if not read:  # a fixed count (BLOCK): i + (limit - i) steps
            done = max(limit, i)
        else:
            back = torch.empty(graph_loop.CTRL_WORDS, dtype=torch.int32, pin_memory=True)
            back.copy_(self.ctrl, non_blocking=True)
            fl = None
            if flags is not None:
                fl = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
                fl.copy_(flags, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            done = int(back[graph_loop.I])
        n = done - i
        launches.add_replay(owner._captured[key][1], times=n)
        launches.add_replay({"loop_cond": n + 1, "feed": n if feed is not None else 0})
        if not read:
            return done, None
        return done, (fl.numpy().copy() if fl is not None else None)

    def _exec(self, owner: GraphSteps, kind: int, key, cond: dict, feed):
        ex = self._execs.get((kind, key))
        if ex is not None:
            return ex
        flags = cond["flags"]
        if cond["rows"] and self._rows is None:
            self._rows = torch.zeros((2, flags.shape[0]), dtype=torch.int32, device=self.device)
        args = graph_loop.cond_args(
            kind, self.ctrl, flags=flags, invert=cond["invert"], step=cond["step"],
            watch=self._rows[0] if cond["rows"] else None,
            budget=self._rows[1] if cond["rows"] else None)
        graph, captured = owner._captured[key]
        try:
            ex = graph_loop.build_loop(graph.raw_cuda_graph(), args,
                                       *(feed if feed is not None else (None, None)))
        except RuntimeError as e:  # named, then raised: no loop runs without its graph
            nccl = captured.get("nccl", 0)
            raise RuntimeError(
                f"{type(owner).__name__}: the loop graph of kind {kind} over the step "
                f"graph at {key}" + (f", which holds {nccl} collectives (mesh=)" if nccl else "")
                + f", was refused: {e}") from e
        self._execs[kind, key] = ex
        return ex


def copy_rt_fields_(dst: RealtimeState, src: RealtimeState) -> None:
    """Copy the fields a Realtime step or prefill replaces from ``src`` into
    the static ``dst`` in place."""
    for name in RT_STEP_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))


class _Prompt:
    """A prefill key's static prompt and mask buffers and, once captured,
    its graph."""

    def __init__(self, B: int, T: int, C: int, device):
        self.ids = torch.zeros((B, T, C), dtype=torch.int64, device=device)
        self.mask = torch.zeros((B, T), dtype=torch.bool, device=device)
        self.warm = False  # a first prefill ran at this key
        self.graph = None
        self.launches = None


class PrefillGraphs:
    """Prefills of ``steps.params`` into a static state, one program per
    key (the prompt's length ``T`` first), over the key's static prompt and
    mask buffers, through CUDA graphs when ``steps`` replays them; the
    graphs share ``steps``' capture stream and memory pool (see the module
    docstring). A subclass says what one prefill does (``_eager``) and
    which keys its calls take. ``after`` (a server's splice of the prefilled
    state into its slots, at control words on the device) ends every
    program, in the same graph: ``after(key)``. ``max_graphs`` keeps that
    many keys, the least recently used dropped first (None keeps every
    key). ``capture_on_use`` False captures only through ``capture()``: a
    key not captured ahead runs eagerly at every use (a server, which must
    not stall its slots for a capture mid-serve), on the caller's stream;
    ``capture()`` then warms the key up on the capture stream itself."""

    def __init__(self, steps: GraphSteps, state, B: int, C: int, device, *,
                 max_graphs: Optional[int] = None, capture_on_use: bool = True,
                 after: Optional[Callable[[tuple], None]] = None):
        self.steps, self.state = steps, state
        self.max_graphs = max_graphs
        self.capture_on_use = capture_on_use
        self.after = after
        self._shape = (B, C, device)
        self._prompts: "OrderedDict[tuple, _Prompt]" = OrderedDict()
        # runs of run(): eager (a key's first use, or graphs off), capture (the
        # key's graph captured, then replayed), replay (a graph captured before)
        self.counts = dict(eager=0, capture=0, replay=0)

    @property
    def keys(self):
        """The keys captured and kept."""
        return tuple(k for k, p in self._prompts.items() if p.graph is not None)

    def _prompt(self, key) -> _Prompt:
        prompt = self._prompts.pop(key, None)
        if prompt is None:
            B, C, device = self._shape
            prompt = _Prompt(B, key[0], C, device)
        self._prompts[key] = prompt  # the most recently used last
        while self.max_graphs is not None and len(self._prompts) > self.max_graphs:
            _, old = self._prompts.popitem(last=False)
            if old.graph is not None:  # let a replay under way end before its graph goes
                torch.cuda.current_stream().synchronize()
        return prompt

    def _run(self, key, ids: torch.Tensor, mask: torch.Tensor) -> None:
        """Prefill ``ids`` (B, T, C) with ``mask`` (B, T), on the host
        (pinned, for a copy that does not wait) or on the device, at
        ``key``."""
        self.steps.check_params()
        prompt = self._prompt(key)
        prompt.ids.copy_(ids, non_blocking=True)
        prompt.mask.copy_(mask, non_blocking=True)
        if prompt.graph is None and prompt.warm and self.steps.graphs and self.capture_on_use:
            self._capture(key, prompt)
            self.counts["capture"] += 1
        elif prompt.graph is not None:
            self.counts["replay"] += 1
        if prompt.graph is not None:
            prompt.graph.replay()
            launches.add_replay(prompt.launches)
        elif self.capture_on_use or not self.steps.graphs:
            self.steps.warm(lambda: self._program(key, prompt))
            prompt.warm = True
            self.counts["eager"] += 1
        else:  # never captured on use: run where the caller runs
            self._program(key, prompt)
            self.counts["eager"] += 1

    def _capture_ahead(self, key) -> None:
        """Capture ``key``'s graph ahead of use (after an eager prefill of
        whatever the key's buffers hold, if none ran)."""
        prompt = self._prompt(key)
        if prompt.graph is not None or not self.steps.graphs:
            return
        if not prompt.warm:
            self.steps.warm(lambda: self._program(key, prompt))
            prompt.warm = True
        self._capture(key, prompt)

    def _capture(self, key, prompt: _Prompt) -> None:
        prompt.graph, prompt.launches = self.steps.capture(
            lambda: self._program(key, prompt))

    def _program(self, key, prompt: _Prompt) -> None:
        self._eager(key, prompt)
        if self.after is not None:
            self.after(key)

    def _eager(self, key, prompt: _Prompt) -> None:
        raise NotImplementedError


class Prefills(PrefillGraphs):
    """Delay prefills (``delay_prefill`` and ``copy_state_``) into the
    static ``state`` (whose cache has the capacity of every prefill) with
    the static ``sampling``: one program per ``(T, top_k_text, top_k_audio,
    hidden_out_layers)``."""

    def __init__(self, steps: DecodeSteps, state: DelayGenState, sampling: DelaySampling,
                 *, max_graphs: Optional[int] = None,
                 after: Optional[Callable[[tuple], None]] = None):
        super().__init__(steps, state, state.pos.shape[0], state.cur_ids.shape[-1],
                         state.pos.device, max_graphs=max_graphs, after=after)
        self.sampling = sampling

    @staticmethod
    def _key(T: int, top_k_text: int, top_k_audio: int, hidden_out_layers) -> tuple:
        return (T, top_k_text, top_k_audio,
                None if hidden_out_layers is None else tuple(hidden_out_layers))

    @torch.no_grad()
    def run(self, ids: torch.Tensor, mask: torch.Tensor, *, top_k_text: int,
            top_k_audio: int, hidden_out_layers=None) -> DelayGenState:
        """Prefill ``ids`` (B, T, C) with ``mask`` (B, T) into the static
        state, which it returns."""
        self._run(self._key(ids.shape[1], top_k_text, top_k_audio, hidden_out_layers), ids,
                  mask)
        return self.state

    @torch.no_grad()
    def capture(self, T: int, *, top_k_text: int, top_k_audio: int,
                hidden_out_layers=None) -> None:
        """Capture the graph of prompts of length ``T`` ahead of use."""
        self._capture_ahead(self._key(T, top_k_text, top_k_audio, hidden_out_layers))

    def _eager(self, key, prompt: _Prompt) -> None:
        _, top_k_text, top_k_audio, hol = key
        st, steps = self.state, self.steps
        copy_state_(st, delay_prefill(
            steps.params, steps.cfg, prompt.ids, prompt.mask, max_new_tokens=1,
            cache_len=st.kv_valid.shape[1], rng=st.rng, sampling=self.sampling,
            top_k_text=top_k_text, top_k_audio=top_k_audio, kv_quant=len(st.cache) == 4,
            cache=st.cache, hidden_out_layers=hol))


class RealtimePrefills(PrefillGraphs):
    """Realtime prefills (``models.realtime.realtime_prefill_step``) into
    the static scalar-cursor ``state`` with the static ``sampling``: one
    program per ``(T, attend_len, top_k)`` (the JAX engine's
    ``_prefill_fn``), which feeds the prompt at the state's cursor (a
    device tensor: a later turn replays the same graph at a later cursor),
    decodes the first frame into ``state.last_audio`` and copies back the
    fields the prefill replaces (``RT_STEP_FIELDS``). ``fresh`` first
    returns the state to a new conversation's, in the program (the JAX
    server's ``_admit_fn``, which makes its state inside the program): the
    cursors, masks, frames and the cache's first ``attend_len`` slots
    (those the prefill reads) zeroed, the last frame the pad frame."""

    def __init__(self, steps: GraphSteps, state: RealtimeState, sampling: RealtimeSampling, *,
                 fresh: bool = False, max_graphs: Optional[int] = None,
                 capture_on_use: bool = True,
                 after: Optional[Callable[[tuple], None]] = None):
        if state.cur_len.ndim != 0:
            raise ValueError("a Realtime prefill program runs on a scalar-cursor state")
        super().__init__(steps, state, state.is_stopping.shape[0],
                         state.last_audio.shape[1] + 1, state.is_stopping.device,
                         max_graphs=max_graphs, capture_on_use=capture_on_use, after=after)
        self.sampling = sampling
        self.fresh = fresh

    @torch.no_grad()
    def run(self, ids: torch.Tensor, mask: torch.Tensor, *, attend_len: Optional[int],
            top_k: int) -> RealtimeState:
        """Prefill ``ids`` (B, T, 1 + rvq) with ``mask`` (B, T) at the
        state's cursor; the first frame is ``state.last_audio``."""
        self._run((ids.shape[1], attend_len, top_k), ids, mask)
        return self.state

    @torch.no_grad()
    def capture(self, T: int, *, attend_len: Optional[int], top_k: int) -> None:
        """Capture the graph of prompts of length ``T`` ahead of use."""
        self._capture_ahead((T, attend_len, top_k))

    def _eager(self, key, prompt: _Prompt) -> None:
        _, attend_len, top_k = key
        st, steps = self.state, self.steps
        if self.fresh:
            for buf in st.cache:
                buf[:, :, :, :attend_len].zero_()
            for t in (st.kv_valid, st.cur_len, st.is_stopping, st.history, st.hist_len):
                t.zero_()
            st.last_audio.fill_(steps.cfg.audio_pad_token)
        new, _ = realtime_prefill_step(steps.params, steps.cfg, st, prompt.ids, prompt.mask,
                                       self.sampling, top_k=top_k, attend_len=attend_len)
        copy_rt_fields_(st, new)


class LocalPrefills(PrefillGraphs):
    """Local prefills (``models.local.local_prefill_split`` and
    ``copy_local_state_``) into the static scalar-cursor ``state``: one
    program per ``(T, n_vq_infer)`` (the batch and the cache length are the
    state's; the JAX engine's ``_prefill_fn``). A prefill draws nothing."""

    def __init__(self, steps: GraphSteps, state: LocalGenState, *,
                 max_graphs: Optional[int] = None, capture_on_use: bool = True,
                 after: Optional[Callable[[tuple], None]] = None):
        if state.pos.ndim != 0:
            raise ValueError("a Local prefill program runs on a scalar-cursor state")
        super().__init__(steps, state, state.unfinished.shape[0],
                         state.cur_ids.shape[-1], state.unfinished.device,
                         max_graphs=max_graphs, capture_on_use=capture_on_use, after=after)

    @torch.no_grad()
    def run(self, ids: torch.Tensor, mask: torch.Tensor, *, n_vq_infer: int) -> LocalGenState:
        """Prefill ``ids`` (B, T, C) with ``mask`` (B, T) into the static
        state, which it returns (its cursor at T - 1, the prompt's last row
        in ``cur_ids``)."""
        self._run((ids.shape[1], n_vq_infer), ids, mask)
        return self.state

    @torch.no_grad()
    def capture(self, T: int, *, n_vq_infer: int) -> None:
        """Capture the graph of prompts of length ``T`` ahead of use."""
        self._capture_ahead((T, n_vq_infer))

    def _eager(self, key, prompt: _Prompt) -> None:
        _, n_vq_infer = key
        st, steps = self.state, self.steps
        copy_local_state_(st, local_prefill_split(
            steps.params, steps.cfg, prompt.ids, prompt.mask, max_new_tokens=1,
            cache_len=st.kv_valid.shape[1], rng=st.rng, n_vq_infer=n_vq_infer,
            dtype=st.cache.k.dtype, cache=st.cache, depth=st.depth))


CODEC_GRAPHS = 8  # chunk keys a codec keeps, the least recently used dropped first


def pool_bytes(pool) -> Optional[int]:
    """The device bytes the caching allocator holds in the graph memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``): the sizes of its
    segments, or None where the allocator's snapshot does not name pools."""
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(pool))


def _leaves(state) -> list:
    """The tensors of a codec stream state: a ``StreamState``, or the
    decoder's ``(StreamState, overlap tail)``."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in _leaves(part)]


def _weights_kind(w):
    return "int8" if is_quantized(w) else w.dtype


class _CodecKey:
    """A codec chunk key's static buffers: the chunk's input (frames or
    codes), its count of real frames ``vlen`` (() int32), the stream state
    and the output; the lock that gives one thread at a time the buffers;
    once captured, the graph, the launches its capture counted and its
    memory pool."""

    def __init__(self, inp: torch.Tensor, state, out: torch.Tensor):
        self.inp, self.state, self.out = inp, state, out
        self.vlen = torch.zeros((), dtype=torch.int32, device=inp.device)
        self.lock = threading.Lock()
        self.warm = False  # a first chunk ran at this key
        self.graph = None
        self.launches = None
        self.pool = None


class CodecChunks:
    """The codec's two chunk programs (JAX ``MossAudioTokenizer._encode_fn``
    and ``_decode_fn``: ``jax.jit`` of ``_encode_chunk`` and
    ``_decode_chunk`` with the stream state donated) over static buffers,
    replayed as CUDA graphs on the card: one program per ``(kind, B, chunk
    frames, levels, weights)``, kind "encode" or "decode", weights the
    parameters' dtype or "int8".

    ``encode`` and ``decode`` run a call chunk by chunk: the chunk is copied
    into the key's input buffer (a short last chunk zero-padded), its count
    of real frames written to ``vlen`` on the device, the program run, and
    the valid part of the output copied out before the next chunk runs. The
    stream state stays in the key's buffers from chunk to chunk (the
    donation's counterpart); a call starts it from zeros, or, for a
    ``streaming()`` session, copies the session's own state in first and
    back out at the end: a graph reads fixed addresses, so a session that
    kept the graph's buffers would need a graph of its own, while the copies
    cost two device-to-device copies of the window a call (11.5 MB each at
    ``codec_1p6b()``'s decoder, f32). Nothing on the path reads a device
    value on the host (``codec/transformer.py``), so one graph serves
    every ``vlen`` and cursor.

    A key's first chunk runs eagerly on the capture stream (it makes
    cuBLAS's handle and workspace, the float64 products of ``rvq_encode``
    included, which a capture may not); the second captures the graph, in a
    memory pool of the key's own, and replays it, and so does every later
    one. ``capture()`` captures ahead; with ``capture_on_use`` set False (a
    server's codec, by ``MossAudioTokenizer.warmup``) a key not captured
    ahead runs eagerly at every chunk, on the caller's stream. With graphs
    off, and always on the CPU, every chunk runs eagerly over the same
    buffers. ``counts`` tells eager chunks, captures and replays apart; the
    launch counts are taken back from a capture and added per replay
    (``ops/kernels/launches.py``). A failed capture or replay raises.

    Threads: one codec serves many at once. A key's lock is held for a
    whole call, so no two threads are inside one key's copy-in, replay and
    copy-out at once; other keys run meanwhile. Captures go through
    ``GraphSteps.capture`` (thread-local mode under ``_CAPTURE_LOCK``), and
    nothing here synchronises the device, only the current stream (before a
    graph is dropped).

    At most ``CODEC_GRAPHS`` keys are kept, the least recently used dropped
    first (``decode(chunk_duration=None)`` makes a key per length). Every
    call first checks that the codec's parameters are still those the
    graphs read (their addresses): ``quantize_tree_(codec.params)``
    replaces them, and then every key is dropped."""

    def __init__(self, codec, *, graphs: bool = True):
        # one way: the codec owns its chunks, so dropping the codec frees its
        # graphs at once, never later in the cycle collector (which may run
        # inside another thread's capture)
        self._codec = weakref.ref(codec)
        self.steps = GraphSteps(codec.params, "dec_in", codec.device, graphs=graphs)
        self.graphs = self.steps.graphs
        self.capture_on_use = True
        self._keys: "OrderedDict[tuple, _CodecKey]" = OrderedDict()
        self._lock = threading.Lock()  # the key table, the counts, the weights' addresses
        self._weights = self._addresses()
        # chunks run: eager (a key's first, graphs off, or not captured
        # ahead), capture (captured, then replayed), replay
        self.counts = dict(eager=0, capture=0, replay=0)
        if self.graphs:  # the capture stream, made once for every thread
            self.steps.warm(lambda: None)

    @property
    def codec(self):
        codec = self._codec()
        if codec is None:
            raise RuntimeError("the codec of these chunk programs was freed")
        return codec

    @property
    def keys(self) -> tuple:
        """The keys captured and kept."""
        with self._lock:
            return tuple(k for k, e in self._keys.items() if e.graph is not None)

    def graph_of(self, key):
        """The captured graph at ``key`` and its memory pool, or None."""
        with self._lock:
            e = self._keys.get(key)
        return None if e is None or e.graph is None else (e.graph, e.pool)

    def _addresses(self) -> tuple:
        return tuple(p.data_ptr() for p in self.codec.params.parameters())

    def check_params(self) -> None:
        """Drop every key if the codec's parameters no longer lie where the
        graphs read them."""
        now = self._addresses()
        with self._lock:
            if now == self._weights:
                return
            self._weights = now
            old = list(self._keys.values())
            self._keys.clear()
        for e in old:
            self._drop(e)

    @staticmethod
    def _drop(e: _CodecKey) -> None:
        with e.lock:
            if e.graph is not None:  # a replay under way ends before its graph goes
                torch.cuda.current_stream().synchronize()
            e.graph = None

    def _entry(self, key, make: Callable[[], _CodecKey]) -> _CodecKey:
        self.check_params()
        with self._lock:
            e = self._keys.pop(key, None)
            if e is None:
                e = make()
            self._keys[key] = e  # the most recently used last
            old = []
            while len(self._keys) > CODEC_GRAPHS:
                old.append(self._keys.popitem(last=False)[1])
        for o in old:
            self._drop(o)
        return e

    def _count(self, kind: str) -> None:
        with self._lock:
            self.counts[kind] += 1

    def _run(self, e: _CodecKey, program: Callable[[_CodecKey], None]) -> None:
        """One chunk at ``e``, whose input and ``vlen`` the caller wrote."""
        fn = functools.partial(program, e)
        if e.graph is None and e.warm and self.graphs and self.capture_on_use:
            self._capture(e, fn)
            self._count("capture")
        elif e.graph is not None:
            self._count("replay")
        if e.graph is not None:
            e.graph.replay()
            launches.add_replay(e.launches)
        elif self.capture_on_use or not self.graphs:
            self.steps.warm(fn)
            e.warm = True
            self._count("eager")
        else:  # never captured on use: run where the caller runs
            fn()
            self._count("eager")

    def _capture(self, e: _CodecKey, fn) -> None:
        e.pool = torch.cuda.graph_pool_handle()
        e.graph, e.launches = self.steps.capture(fn, pool=e.pool)

    # ------------------------------------------------------------ programs
    def _encode_key(self, B: int, cf: int, nq: int):
        codec = self.codec
        cfg, p, dev = codec.config, codec.params, codec.device

        def make():
            txf = _txf_cfg(cfg, cfg.num_encoder_layers)
            return _CodecKey(
                torch.zeros((B, cf, cfg.hop), dtype=codec.encode_dtype, device=dev),
                init_stream_state(txf, B, cfg.causal_context, dtype=p.enc_in.dtype, device=dev),
                torch.zeros((nq, B, cf), dtype=torch.int32, device=dev))

        def program(e: _CodecKey) -> None:
            codes, new = _encode_chunk(codec.params, cfg, e.state, e.inp, e.vlen, nq)
            e.out.copy_(codes)
            for d, s in zip(_leaves(e.state), _leaves(new)):
                d.copy_(s)

        return self._entry(("encode", B, cf, nq, _weights_kind(p.enc_in)), make), program

    def _decode_key(self, B: int, cf: int, nq: int):
        codec = self.codec
        cfg, p, dev = codec.config, codec.params, codec.device

        def make():
            return _CodecKey(torch.zeros((nq, B, cf), dtype=torch.int64, device=dev),
                             codec._init_decode_state(B),
                             torch.zeros((B, cf * cfg.hop), dtype=p.dec_in.dtype, device=dev))

        def program(e: _CodecKey) -> None:
            wav, new = _decode_chunk(codec.params, cfg, e.state, e.inp, e.vlen)
            e.out.copy_(wav)
            for d, s in zip(_leaves(e.state), _leaves(new)):
                d.copy_(s)

        return self._entry(("decode", B, cf, nq, _weights_kind(p.dec_in)), make), program

    @torch.no_grad()
    def encode(self, frames: torch.Tensor, num_quantizers: int, chunk_frames: int
               ) -> torch.Tensor:
        """frames (B, T, hop) in ``codec.encode_dtype`` on the codec's device
        -> codes (NQ, B, T) int32 there, ``chunk_frames`` at a time."""
        B, T, _ = frames.shape
        e, program = self._encode_key(B, chunk_frames, num_quantizers)
        codes = torch.empty((num_quantizers, B, T), dtype=torch.int32, device=frames.device)
        with e.lock:
            for t in _leaves(e.state):
                t.zero_()
            for start in range(0, T, chunk_frames):
                n = min(chunk_frames, T - start)
                e.inp[:, :n].copy_(frames[:, start:start + n])
                e.inp[:, n:].zero_()
                e.vlen.fill_(n)
                self._run(e, program)
                codes[:, :, start:start + n].copy_(e.out[:, :, :n])
        return codes

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, chunk_frames: int, state=None) -> torch.Tensor:
        """codes (NQ, B, T) int64 on the codec's device -> wave (B, T * hop)
        in the decoder's dtype there, ``chunk_frames`` at a time, from a
        fresh stream, or continuing ``state`` (a session's ``(StreamState,
        tail)`` of B rows, updated in place)."""
        NQ, B, T = codes.shape
        hop = self.codec.config.hop
        e, program = self._decode_key(B, chunk_frames, NQ)
        wav = torch.empty((B, T * hop), dtype=e.out.dtype, device=codes.device)
        with e.lock:
            if state is None:
                for t in _leaves(e.state):
                    t.zero_()
            else:
                for d, s in zip(_leaves(e.state), _leaves(state)):
                    d.copy_(s)
            for start in range(0, T, chunk_frames):
                n = min(chunk_frames, T - start)
                e.inp[:, :, :n].copy_(codes[:, :, start:start + n])
                e.inp[:, :, n:].zero_()
                e.vlen.fill_(n)
                self._run(e, program)
                wav[:, start * hop:(start + n) * hop].copy_(e.out[:, :n * hop])
            if state is not None:
                for d, s in zip(_leaves(state), _leaves(e.state)):
                    d.copy_(s)
        return wav

    @torch.no_grad()
    def capture(self, kind: str, *, batch: int, chunk_frames: int, num_quantizers: int) -> None:
        """Capture the graph of ``kind`` ("encode" or "decode") chunks of
        ``chunk_frames`` frames, ``batch`` rows and ``num_quantizers``
        levels ahead of use (after an eager chunk of zeros on the capture
        stream, if none ran). Nothing with graphs off."""
        if not self.graphs:
            return
        key = {"encode": self._encode_key, "decode": self._decode_key}[kind]
        e, program = key(batch, chunk_frames, num_quantizers)
        with e.lock:
            if e.graph is not None:
                return
            for t in [e.inp] + _leaves(e.state):
                t.zero_()
            e.vlen.fill_(chunk_frames)
            fn = functools.partial(program, e)
            if not e.warm:
                self.steps.warm(fn)
                e.warm = True
            self._capture(e, fn)
