"""Audio sample conversion for the serving front end.

The port's own copy of what it needs from ``mosstts_tpu/utils/native.py``:
``float_to_pcm16`` and ``crossfade``, in numpy. The JAX package's functions
have two paths that disagree: its C library (``native/audio_kernels.cpp``)
rounds PCM16 with ``lrintf``, half to even, where its numpy fallback
truncates, and builds the crossfade ramp in float32 with a fused
multiply-add, where its fallback takes a float64 ``linspace`` and two
roundings. These copies compute as the C library does, so they give the
JAX package's samples wherever that library loads.
"""
from __future__ import annotations

import numpy as np


def float_to_pcm16(wav: np.ndarray) -> np.ndarray:
    """float samples in [-1, 1] -> little-endian int16: scaled by 32767 in
    float32, clipped to [-32768, 32767], rounded half to even."""
    x = np.ascontiguousarray(wav, np.float32).reshape(-1)
    return np.rint(np.clip(x * np.float32(32767.0), -32768, 32767)).astype("<i2")


def crossfade(prev_tail: np.ndarray, wav: np.ndarray, n_overlap: int) -> np.ndarray:
    """``[prev_tail minus its last n | seam | wav past its first n]``, the
    seam a linear equal-gain ramp over n = min(n_overlap, both lengths)
    samples: ``fade_out = 1 - i / max(1, n - 1)`` and ``fade_in = 1 -
    fade_out`` in float32, ``prev * fade_out + wav * fade_in`` with the
    first product fused into the sum (one rounding), as the C library's
    ``crossfade`` compiles."""
    p = np.ascontiguousarray(prev_tail, np.float32).reshape(-1)
    w = np.ascontiguousarray(wav, np.float32).reshape(-1)
    n = min(int(n_overlap), p.size, w.size)
    i = np.arange(n, dtype=np.float32)
    fade_out = np.float32(1.0) - i / np.float32(max(1, n - 1))
    fade_in = np.float32(1.0) - fade_out
    seam = (p[p.size - n:].astype(np.float64) * fade_out.astype(np.float64)
            + (w[:n] * fade_in).astype(np.float64)).astype(np.float32)
    return np.concatenate([p[:p.size - n], seam, w[n:]])
