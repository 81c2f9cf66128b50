"""Serving pool: concurrent request threads share one continuous-batching
server.

Ports ``mosstts_tpu/serve/pool.py``: ``DelayServingPool``,
``RealtimeStreamHandle`` and ``RealtimeServingPool``. The HTTP front
end (``serve/http_server.py``) is a ``ThreadingHTTPServer``; without a pool
every concurrent request runs its own solo generate, one after another on
the one engine. The pool gives the process one ``DelayBatchServer`` and a
background decode thread; request threads submit and block on a completion
event, so concurrent requests share batch slots (mid-flight admission,
per-request sampling).

``DelayServingPool.generate`` takes the engine's arguments and returns what
the engine returns, [(start_length, tokens)], so ``serve/pipelines.py``
uses it in place of ``engine.generate`` when the backend carries a pool.
On the card the decode thread's steps are CUDA-graph replays, and it
captures a new attend bucket's graph when the batch first reaches it, while
handler threads run the codec on the card (``engine/step_graph.py`` says
how captures and other threads coexist).

``RealtimeServingPool`` does the same for ``POST /stream``: concurrent
streams share one ``RealtimeBatchServer``, and each stream's frames ship
incrementally (``partial_frames``) while it decodes. Its decode thread
replays and captures the frame graphs under the same discipline: a capture
runs in thread-local mode under the process-wide lock, while handler
threads run the codec on the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..engine.batch_server import DelayBatchServer


class DelayServingPool:
    """Ports ``mosstts_tpu.serve.pool.DelayServingPool``: a thread-safe
    facade over ``DelayBatchServer``.

    One background thread owns the decode loop; any number of request
    threads call :meth:`generate`. All server mutation happens under one
    lock, held by the decode thread for one poll window (``step_block``) at
    a time."""

    def __init__(self, params, config, *, slots: int = 4, idle_wait: float = 0.02,
                 **server_kw):
        self.server = DelayBatchServer(params, config, slots=slots, **server_kw)
        self._lock = threading.Lock()
        self._results: Dict[int, object] = {}
        self._events: Dict[int, threading.Event] = {}
        self._abandoned: set = set()  # timed-out rids; results dropped on arrival
        self._wake = threading.Event()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._idle_wait = idle_wait
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mosstts-serving-pool")
        self._thread.start()

    def supports(self, *, text_top_k: int, audio_top_k: int) -> bool:
        """Top-k widths are static for the server (one decode graph per
        width); a request needing other widths runs on the solo engine, to
        which ``serve/pipelines.py`` routes it."""
        return (text_top_k == self.server.top_k_text
                and audio_top_k == self.server.top_k_audio)

    # ------------------------------------------------------------------
    def warmup(self, **kw):
        """``DelayBatchServer.warmup`` under the pool's lock."""
        with self._lock:
            self.server.warmup(**kw)

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    def _loop(self):
        while not self._stop:
            try:
                with self._lock:
                    busy = bool(self.server._active or self.server._queue)
                    # one poll window per dispatch (step_block)
                    done = self.server.step_block() if busy else []
            except BaseException as e:
                # a dead decode thread fails every pending and later
                # generate() instead of leaving them to wait forever; under
                # _lock, so a generate() that registers its events either
                # sees _error afterwards or has its events set here
                with self._lock:
                    self._error = e
                    for ev in list(self._events.values()):
                        ev.set()
                    self._events.clear()
                if not isinstance(e, Exception):
                    raise
                return
            for c in done:
                with self._lock:
                    if c.request_id in self._abandoned:
                        self._abandoned.discard(c.request_id)
                        continue  # its waiter timed out: drop, don't leak
                    self._results[c.request_id] = c
                    ev = self._events.pop(c.request_id, None)
                if ev is not None:
                    ev.set()
            if not busy:
                self._wake.wait(self._idle_wait)
                self._wake.clear()

    # ------------------------------------------------------------------
    def generate(
        self,
        input_ids: np.ndarray,  # (B, T, C) left-padded
        attention_mask: Optional[np.ndarray] = None,
        *,
        max_new_tokens: int = 1000,
        text_temperature: float = 1.5,
        text_top_p: float = 1.0,
        text_top_k: int = 50,  # must match the pool's server-static widths
        audio_top_k: int = 25,  # (see supports(); pipelines gates on it)
        audio_temperature: float = 1.7,
        audio_top_p: float = 0.8,
        audio_repetition_penalty: float = 1.0,
        audio_rp_cross_batch: bool = False,
        seed: int = 0,
        on_device: bool = False,  # accepted for the engine's signature
        poll_every: int = 8,
        timeout: Optional[float] = None,
    ) -> List[Tuple[int, np.ndarray]]:
        """``DelayEngine.generate`` through the shared pool: each row becomes
        one pool request (its left padding stripped; the server pads to its
        prompt bucket) with this call's sampling. Blocks until every row
        completes; raises ``TimeoutError`` after ``timeout`` seconds, and
        ``RuntimeError`` if the decode thread died.

        ``seed`` goes into row b's request as hash((seed, b)), so a seeded
        call gives the same tokens on every call, whatever the server's
        request ids."""
        del on_device, poll_every
        if not self.supports(text_top_k=text_top_k, audio_top_k=audio_top_k):
            raise ValueError(
                f"pool serves top_k=({self.server.top_k_text}, {self.server.top_k_audio}) "
                f"but the request asked ({text_top_k}, {audio_top_k}); use the solo engine "
                "(pipelines routes there)")
        if audio_rp_cross_batch:
            raise ValueError(
                "audio_rp_cross_batch ties the rows of one batch together; pool requests "
                "are independent: use the solo engine")
        input_ids = np.asarray(input_ids, np.int64)
        B, T, C = input_ids.shape
        if attention_mask is None:
            attention_mask = np.ones((B, T), bool)
        sampling = dict(
            text_temperature=text_temperature, text_top_p=text_top_p,
            audio_temperature=audio_temperature, audio_top_p=audio_top_p,
            audio_repetition_penalty=audio_repetition_penalty,
        )
        rids, events = [], []
        with self._lock:
            if self._error is not None:
                raise RuntimeError("serving pool decode thread died") from self._error
            for b in range(B):
                valid = np.nonzero(attention_mask[b])[0]
                grid = input_ids[b, valid[0]:] if len(valid) else input_ids[b, -1:]
                rid = self.server.submit(grid, max_new_tokens=max_new_tokens,
                                         sampling=sampling, seed=hash((seed, b)) & 0x7FFFFFFF)
                ev = threading.Event()
                self._events[rid] = ev
                rids.append(rid)
                events.append(ev)
        self._wake.set()
        for ev in events:
            if not ev.wait(timeout):
                # unregister the whole call, so that late results are dropped
                # in _loop instead of kept forever (the requests still run to
                # their max_new_tokens on the server and free their slots)
                with self._lock:
                    for rid in rids:
                        if self._events.pop(rid, None) is not None or \
                                self._results.pop(rid, None) is None:
                            self._abandoned.add(rid)
                raise TimeoutError("pool generate timed out")
        if self._error is not None:
            raise RuntimeError("serving pool decode thread died") from self._error
        out = []
        for rid in rids:
            c = self._results.pop(rid)
            out.append((c.start_length, c.tokens))
        return out


class RealtimeStreamHandle:
    """Ports ``mosstts_tpu.serve.pool.RealtimeStreamHandle``: the consumer
    side of one pooled streaming conversation: iterate :meth:`frames` to
    receive np.ndarray frame blocks as they decode; iteration ends when the
    conversation completes. :meth:`result` blocks
    and returns all frames concatenated (solo-engine-shaped)."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self._emitted = 0  # frames already shipped (pool-thread side)
        self._error: Optional[BaseException] = None

    def frames(self, timeout: Optional[float] = None):
        while True:
            try:
                block = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no frame within {timeout}s (stream "
                    f"{self.request_id})") from None
            if block is None:
                if self._error is not None:
                    raise RuntimeError(
                        "realtime pool decode thread died") from self._error
                return
            yield block

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        blocks = list(self.frames(timeout=timeout))
        if not blocks:
            return np.zeros((0, 0), np.int64)
        return np.concatenate(blocks, axis=0)


class RealtimeServingPool:
    """Ports ``mosstts_tpu.serve.pool.RealtimeServingPool``: concurrent HTTP
    /stream sessions share one ``RealtimeBatchServer``; each stream becomes a
    pool conversation (mid-flight admission, per-request sampling), and its
    frames ship incrementally through ``partial_frames()``, so wave chunks
    flow while the conversation still decodes. One background thread owns
    the decode loop, one frame per lock hold."""

    def __init__(self, params, config, *, slots: int = 4,
                 fetch_every: int = 4, idle_wait: float = 0.02, **server_kw):
        from ..engine.realtime_batch_server import RealtimeBatchServer

        self.server = RealtimeBatchServer(params, config, slots=slots,
                                          **server_kw)
        self.fetch_every = max(1, fetch_every)
        self._lock = threading.Lock()
        self._handles: Dict[int, RealtimeStreamHandle] = {}
        self._wake = threading.Event()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._idle_wait = idle_wait
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mosstts-rt-pool")
        self._thread.start()

    def supports(self, *, top_k: int) -> bool:
        """The top-k width is static for the server (one frame graph per
        width); a stream needing another width runs on the solo session,
        where ``http_server`` routes it."""
        return top_k == self.server.top_k

    def warmup(self, **kw):
        """``RealtimeBatchServer.warmup`` under the pool's lock."""
        with self._lock:
            self.server.warmup(**kw)

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        # release any consumer still blocked in frames(): the loop thread
        # is gone, so no sentinel would ever arrive. Mark the stream as
        # errored — it is truncated, not complete.
        with self._lock:
            for h in self._handles.values():
                if h._error is None:
                    h._error = RuntimeError("pool closed mid-stream")
                h._q.put(None)
            self._handles.clear()

    # ------------------------------------------------------------------
    def open_stream(self, grid: np.ndarray, text_ids, *,
                    max_new_tokens: int = 128, prefill_text_len: int = 12,
                    sampling: Optional[dict] = None) -> RealtimeStreamHandle:
        """Submit one conversation turn; returns a handle whose
        :meth:`RealtimeStreamHandle.frames` yields frame blocks live."""
        with self._lock:
            if self._error is not None:
                raise RuntimeError(
                    "realtime pool decode thread died") from self._error
            rid = self.server.submit(
                grid, list(text_ids), max_new_tokens=max_new_tokens,
                prefill_text_len=prefill_text_len, sampling=sampling)
            handle = RealtimeStreamHandle(rid)
            self._handles[rid] = handle
        self._wake.set()
        return handle

    def cancel(self, handle: RealtimeStreamHandle) -> bool:
        """Abort a pooled stream (client disconnected): frees the server
        slot immediately instead of decoding the abandoned conversation to
        its frame budget. Idempotent; safe against the conversation
        completing concurrently."""
        with self._lock:
            found = self.server.cancel(handle.request_id)
            if self._handles.pop(handle.request_id, None) is not None:
                handle._q.put(None)  # release a consumer blocked in frames()
        return found

    # ------------------------------------------------------------------
    def _ship(self, handle: RealtimeStreamHandle, frames: np.ndarray):
        if len(frames) > handle._emitted:
            handle._q.put(frames[handle._emitted:].copy())
            handle._emitted = len(frames)

    def _loop(self):
        while not self._stop:
            try:
                with self._lock:
                    busy = bool(self.server._active or self.server._queue)
                    done = self.server.step() if busy else []
                    fetch = busy and (
                        self.server.total_steps % self.fetch_every == 0)
                    partial = self.server.partial_frames() if fetch else {}
            except BaseException as e:  # noqa: BLE001 - surfaced to callers
                with self._lock:
                    self._error = e
                    for h in self._handles.values():
                        h._error = e
                        h._q.put(None)
                    self._handles.clear()
                return
            for rid, frames in partial.items():
                h = self._handles.get(rid)
                if h is not None:
                    self._ship(h, frames)
            for c in done:
                h = self._handles.pop(c.request_id, None)
                if h is not None:
                    self._ship(h, c.frames)
                    h._q.put(None)
            if not busy:
                self._wake.wait(self._idle_wait)
                self._wake.clear()
