"""Host-side audio I/O and DSP (numpy): stdlib ``wave`` for RIFF I/O, a
polyphase resampler and loudness normalisation.

The port's own copy of ``mosstts_tpu/utils/audio.py``, which
``processing/delay_processor.py`` needs. The JAX package's optional C++
helpers (``mosstts_tpu/utils/native.py``) are not carried over: resampling
goes to scipy (linear interpolation without it), and loudness normalisation
computes in numpy what the C helper computes (float64 mean square, one
float32 gain).
"""
from __future__ import annotations

import wave
from math import gcd
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Returns (samples (channels, T) float32 in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    return data.reshape(-1, ch).T.copy(), sr


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """samples: (T,) or (channels, T) float32 in [-1, 1] -> 16-bit PCM."""
    samples = np.nan_to_num(np.asarray(samples, np.float32))
    if samples.ndim == 1:
        samples = samples[None]
    pcm = np.clip(samples.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis (scipy; linear interpolation
    where scipy is missing)."""
    if orig_sr == new_sr:
        return wav
    g = gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // g, orig_sr // g
    try:
        from scipy.signal import resample_poly
    except ImportError:
        t_old = np.arange(wav.shape[-1]) / orig_sr
        n_new = int(round(wav.shape[-1] * new_sr / orig_sr))
        t_new = np.arange(n_new) / new_sr
        if wav.ndim == 1:
            return np.interp(t_new, t_old, wav).astype(np.float32)
        return np.stack([np.interp(t_new, t_old, row) for row in wav]).astype(np.float32)
    return resample_poly(wav, up, down, axis=-1).astype(np.float32)


def loudness_normalize(
    wav: np.ndarray, target_dbfs: float = -20.0, gain_range=(-3.0, 3.0)
) -> np.ndarray:
    """Match reference loudness normalization (processing_moss_tts.py:735-748):
    RMS-dBFS toward target, gain clamped to +/-3 dB. The mean square is
    taken in float64 and the gain rounded once to float32, as the JAX
    package's C helper (``native/audio_kernels.cpp`` ``loudness_gain``)
    does."""
    wav = np.asarray(wav, np.float32)
    if wav.size == 0:
        return wav
    w64 = wav.astype(np.float64)
    current = 10.0 * np.log10(float(np.mean(w64 * w64)) + 1e-9)
    gain = float(np.clip(target_dbfs - current, gain_range[0], gain_range[1]))
    return wav * np.float32(10.0 ** (gain / 20.0))


def to_mono(wav: np.ndarray) -> np.ndarray:
    """(channels, T) -> (T,)."""
    if wav.ndim == 2:
        return wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
    return wav
