"""Serving metrics and profiling spans.

Ports ``mosstts_tpu/engine/metrics.py``: ``SynthesisMetrics`` (time to
first audio, realtime factor, frames per second, named spans) and
``trace_span``, which marks a span in ``torch.profiler`` traces with
``record_function`` (in place of ``jax.profiler.TraceAnnotation``) and, once
the process uses the card, in NVTX as well.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace_span(name: str):
    """A named span: a ``torch.profiler`` record (nothing is recorded when
    no profiler runs) and, when CUDA is initialised in this process, an
    NVTX range."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@dataclass
class SynthesisMetrics:
    """Ports ``mosstts_tpu.engine.metrics.SynthesisMetrics``: tracks one
    synthesis or streaming session."""

    sample_rate: int = 24000
    frame_rate: float = 12.5
    started_at: float = field(default_factory=time.monotonic)
    first_audio_at: Optional[float] = None
    audio_samples: int = 0
    frames: int = 0
    prefill_seconds: float = 0.0
    spans: Dict[str, float] = field(default_factory=dict)

    def mark_first_audio(self):
        if self.first_audio_at is None:
            self.first_audio_at = time.monotonic()

    def add_audio(self, n_samples: int):
        if n_samples > 0:
            self.mark_first_audio()
            self.audio_samples += int(n_samples)

    def add_frames(self, n: int):
        self.frames += int(n)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        with trace_span(name):
            yield
        self.spans[name] = self.spans.get(name, 0.0) + time.monotonic() - t0

    @property
    def ttfa(self) -> Optional[float]:
        """Time to first audio."""
        if self.first_audio_at is None:
            return None
        return self.first_audio_at - self.started_at

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.started_at

    @property
    def rtf(self) -> Optional[float]:
        """Realtime factor: audio seconds produced per wall second."""
        if self.audio_samples == 0 or self.elapsed <= 0:
            return None
        return (self.audio_samples / self.sample_rate) / self.elapsed

    @property
    def frames_per_second(self) -> Optional[float]:
        if self.frames == 0 or self.elapsed <= 0:
            return None
        return self.frames / self.elapsed

    def report(self) -> Dict:
        return {
            "ttfa_s": round(self.ttfa, 4) if self.ttfa is not None else None,
            "rtf_x": round(self.rtf, 3) if self.rtf is not None else None,
            "audio_s": round(self.audio_samples / self.sample_rate, 3),
            "frames": self.frames,
            "frames_per_s": round(self.frames_per_second, 1)
            if self.frames_per_second else None,
            "elapsed_s": round(self.elapsed, 3),
            "spans": {k: round(v, 3) for k, v in self.spans.items()},
        }

    def json(self) -> str:
        return json.dumps(self.report())
