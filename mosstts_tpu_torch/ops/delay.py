"""Delay-pattern codebook scheduling (host-side, numpy).

Codebook k is shifted k steps later in time: a (T, n_vq) grid becomes
(T + n_vq - 1, n_vq) with pad codes filling the triangle corners
(reference processing_moss_tts.py:516-537; moss_tts_delay/README.md:7-56).
Implemented as vectorized gathers instead of the reference's per-column
python loop.

The port's own copy of ``mosstts_tpu/ops/delay.py``.
"""
from __future__ import annotations

import numpy as np


def apply_delay_pattern(codes: np.ndarray, pad_code: int) -> np.ndarray:
    """(T, n_vq) -> (T + n_vq - 1, n_vq); out[t, k] = codes[t - k, k]."""
    T, n = codes.shape
    out_t = np.arange(T + n - 1)[:, None]  # (T', 1)
    k = np.arange(n)[None, :]  # (1, n)
    src = out_t - k
    valid = (src >= 0) & (src < T)
    gathered = codes[np.clip(src, 0, T - 1), k]
    return np.where(valid, gathered, pad_code).astype(codes.dtype)


def apply_de_delay_pattern(delay_codes: np.ndarray) -> np.ndarray:
    """(T', n_vq) -> (T' - n_vq + 1, n_vq); inverse of apply_delay_pattern."""
    Tp, n = delay_codes.shape
    T = Tp - n + 1
    t = np.arange(T)[:, None]
    k = np.arange(n)[None, :]
    return delay_codes[t + k, k]
