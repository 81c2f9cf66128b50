"""Delay decode steps over static buffers, replayed as CUDA graphs on the card.

The port's counterpart of the JAX package's compiled step programs:
``jax.jit`` of ``delay_decode_step`` with the state donated
(``mosstts_tpu/engine/delay_engine.py:125``, ``batch_server.py:398``).

``DecodeSteps`` owns one ``DelayGenState`` and one ``DelaySampling`` whose
tensors never move, and advances the state in place, one decode step per
``step()``. On the card a step is the replay of a CUDA graph of one
``delay_decode_step``, one graph per ``(attend_len, uniform_slots,
top_k_text, top_k_audio)``. The graph ends by copying every field the step
replaces (``STEP_FIELDS``) back into its buffer, as a donated JAX buffer is
reused; the cache, ``kv_valid``, ``out`` and ``out_valid`` are written in
place by the step itself. A block of k steps (JAX's ``_block_fn``, a
``fori_loop`` program) is k replays of the one-step graph.

The first step at a key runs eagerly on the capture stream: it is a real
step, and it builds the kernels, sets their shared-memory limits and makes
cuBLAS's handle and workspace, none of which a capture may do. Then the
graph is captured (a capture runs nothing) and every later step at that key
replays it. The rows' generators are registered with each graph, so a
replay draws from their current seed and offset exactly as an eager step
would, and ``ops.sampling.reseed_generators_`` between replays takes effect
at the next one. All graphs of one ``DecodeSteps`` share one memory pool:
nothing a capture allocates is read after its graph ends, so they may
replay in any order, one at a time. A failed capture or replay raises; nothing falls back
to eager steps.

With ``graphs=False``, and always for CPU tensors, each step runs eagerly
and copies its fields back the same way, so the two paths share everything
but how the step's kernels are issued.

Every tensor a graph reads must outlive it at the same address: the
weights (``quantize()`` replaces them, so an owner drops its
``DecodeSteps`` then), the state and sampling buffers, and the paged table.
``step()`` raises if the parameters' text head is no longer the one it was
built with.

Captures may happen while other threads use the card: the serving pool's
decode thread captures a new attend bucket while HTTP handler threads run
the codec or a solo engine. So a capture runs in CUDA's thread-local capture
mode, in which only the capturing thread is barred from calls a capture
forbids, and captures are serialised process-wide (``_CAPTURE_LOCK``):
``torch.cuda.graph`` synchronises the device and empties the allocator's
cache before it begins, which would break a capture under way in another
thread. Other threads must not synchronise the whole device while a
capture may run; a stream's or an event's synchronisation is fine.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from ..core.config import DelayConfig
from ..models.delay import DelayGenState, DelayParams, DelaySampling, delay_decode_step
from ..ops.kernels import launches

# one capture at a time in the process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()

# the DelayGenState fields delay_decode_step returns as new tensors
STEP_FIELDS = ("cur_ids", "pos", "step", "is_stopping", "is_audio", "audio_lengths",
               "delayed", "seen")


def copy_state_(dst: DelayGenState, src: DelayGenState) -> None:
    """Copy ``src`` (a prefill's state) into the static ``dst`` in place; a
    cache the prefill already wrote in place (``delay_prefill(cache=...)``)
    is not copied. ``dst.out``/``out_valid`` may hold more steps than
    ``src``'s: the rest is zeroed. Both states must draw from the same
    generators."""
    if len(dst.rng) != len(src.rng) or any(a is not b for a, b in zip(dst.rng, src.rng)):
        raise ValueError("copy_state_: the states draw from different generators")
    for d, s in zip(dst.cache, src.cache):
        if d is not s:
            d.copy_(s)
    for name in ("kv_valid",) + STEP_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))
    for name in ("out", "out_valid"):
        d, s = getattr(dst, name), getattr(src, name)
        d[:, :s.shape[1]].copy_(s)
        d[:, s.shape[1]:].zero_()


class DecodeSteps:
    """Decode steps of ``params`` over the static ``state`` and ``sampling``.
    ``graphs`` replays CUDA graphs for CUDA tensors."""

    def __init__(self, params: DelayParams, cfg: DelayConfig, state: DelayGenState,
                 sampling: DelaySampling, *, graphs: bool = True):
        self.params, self.cfg, self.state, self.sampling = params, cfg, state, sampling
        self.graphs = graphs and state.pos.device.type == "cuda"
        self.pool = None  # the graphs' memory pool, made at the first capture
        self._head = params.text_head
        self._stream: Optional[torch.cuda.Stream] = None
        self._captured = {}  # key -> (CUDAGraph, the launches its capture counted)

    @property
    def keys(self):
        """The keys captured so far."""
        return tuple(self._captured)

    @torch.no_grad()
    def step(self, *, attend_len: Optional[int], uniform_slots: bool, top_k_text: int,
             top_k_audio: int) -> None:
        """One decode step of the whole batch, in place."""
        if self.params.text_head is not self._head:
            raise RuntimeError("the parameters were replaced since these decode steps were "
                               "built (quantize()?): build new ones")
        key = (attend_len, uniform_slots, top_k_text, top_k_audio)
        entry = self._captured.get(key)
        if entry is not None:
            entry[0].replay()
            launches.add_replay(entry[1])
            return
        if not self.graphs:
            self._eager(key)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.state.pos.device)
            self.pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._eager(key)  # the warm-up, a real step
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.state.rng:
            graph.register_generator_state(gen)
        with _CAPTURE_LOCK:
            before = launches.read()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self._eager(key)
            finally:
                captured = launches.since(before)
                launches.restore(before)
        self._captured[key] = (graph, captured)

    def _eager(self, key) -> None:
        attend_len, uniform_slots, top_k_text, top_k_audio = key
        new = delay_decode_step(self.params, self.cfg, self.state, self.sampling,
                                top_k_text=top_k_text, top_k_audio=top_k_audio,
                                attend_len=attend_len, uniform_slots=uniform_slots)
        for name in STEP_FIELDS:
            getattr(self.state, name).copy_(getattr(new, name))
