"""Audio sample conversion for the serving front end.

The port's own copy of what it needs from ``mosstts_tpu/utils/native.py``:
``float_to_pcm16``, in numpy. The JAX package's function has two paths that
disagree: its C library (``native/audio_kernels.cpp``) rounds with
``lrintf``, half to even, and its numpy fallback truncates. This copy
rounds as the C library does, so it gives the JAX package's bytes wherever
that library loads.
"""
from __future__ import annotations

import numpy as np


def float_to_pcm16(wav: np.ndarray) -> np.ndarray:
    """float samples in [-1, 1] -> little-endian int16: scaled by 32767 in
    float32, clipped to [-32768, 32767], rounded half to even."""
    x = np.ascontiguousarray(wav, np.float32).reshape(-1)
    return np.rint(np.clip(x * np.float32(32767.0), -32768, 32767)).astype("<i2")
