"""Synthetic speech for codec training and evaluation, from numpy alone.

A copy of ``mosstts_tpu/codec/speech_synth.py`` (numpy only, no JAX):
``synthesize_utterance``, ``synthetic_speech_batch``,
``synthetic_speech_iter`` and ``mcd_db``. The audio has the acoustic
structure a codec has to model: a glottal harmonic source with pitch
declination, vibrato and jitter, a 3-formant vocal-tract envelope following
vowel-to-vowel trajectories (coarticulated through unvoiced gaps),
fricative noise bursts, aspiration and per-segment energy contours, with no
audio corpus needed. Synthesis is additive (harmonics sampled from the
formant envelope per 10 ms frame, phase-continuous across frames) plus
FFT-shaped noise, vectorized, fast enough to make batches during training.
``mcd_db`` is the mel-cepstral distortion ``CodecTrainer.evaluate``
reports.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

# (F1, F2, F3) targets in Hz for a handful of vowel qualities; bandwidths
# are sampled per utterance around typical adult values
_VOWELS = np.array([
    [800.0, 1200.0, 2500.0],   # a
    [300.0, 2300.0, 3000.0],   # i
    [325.0, 750.0, 2500.0],    # u
    [500.0, 1800.0, 2500.0],   # e
    [450.0, 880.0, 2550.0],    # o
    [600.0, 1700.0, 2600.0],   # E
    [500.0, 1500.0, 2500.0],   # schwa
], np.float32)

_FRAME_S = 0.01  # 10 ms analysis/synthesis frame grid


def _formant_envelope(freqs: np.ndarray, F: np.ndarray, B: np.ndarray
                      ) -> np.ndarray:
    """|H(f)| of a cascade of 3 second-order resonators, broadcast over
    leading frame axes. freqs (...,K), F/B (...,3) -> (...,K)."""
    f2 = freqs[..., None, :] ** 2
    Fi = F[..., :, None]
    Bi = B[..., :, None]
    mag = (Fi ** 2 + 1e-3) / np.sqrt((Fi ** 2 - f2) ** 2 + (Bi * freqs[..., None, :]) ** 2 + 1e-6)
    return np.prod(mag, axis=-2)


def _segments(rng: np.random.Generator, seconds: float
              ) -> List[Tuple[str, float]]:
    """Alternating plan of (kind, duration) segments: 'v' voiced vowel-ish,
    'f' fricative burst, 's' silence/pause."""
    out, t = [], 0.0
    while t < seconds:
        r = rng.random()
        if r < 0.70:
            seg = ("v", float(rng.uniform(0.08, 0.30)))
        elif r < 0.88:
            seg = ("f", float(rng.uniform(0.04, 0.15)))
        else:
            seg = ("s", float(rng.uniform(0.03, 0.12)))
        out.append(seg)
        t += seg[1]
    return out


def _smooth(x: np.ndarray, n: int) -> np.ndarray:
    if n <= 1 or x.shape[0] < 2:
        return x
    k = np.ones(n, np.float32) / n
    pad = np.concatenate([np.repeat(x[:1], n, 0), x, np.repeat(x[-1:], n, 0)])
    sm = np.stack([np.convolve(pad[:, i], k, "same") for i in range(x.shape[1])], 1)
    return sm[n:-n]


def synthesize_utterance(rng: np.random.Generator, seconds: float,
                         sample_rate: int) -> np.ndarray:
    L = int(seconds * sample_rate)
    hop = max(1, int(_FRAME_S * sample_rate))
    n_frames = L // hop + 2

    # ---- frame-level prosody tracks -------------------------------------
    base_f0 = float(rng.uniform(85.0, 260.0))
    segs = _segments(rng, seconds)
    voiced = np.zeros(n_frames, bool)
    fric = np.zeros(n_frames, bool)
    energy = np.zeros(n_frames, np.float32)
    targets = np.zeros((n_frames, 3), np.float32)
    f0_seg = np.zeros(n_frames, np.float32)

    frame_t = np.arange(n_frames, dtype=np.float32) * _FRAME_S
    fi = 0
    last_target = _VOWELS[rng.integers(len(_VOWELS))] * rng.uniform(0.9, 1.1, 3)
    for kind, dur in segs:
        n = max(1, int(round(dur / _FRAME_S)))
        sl = slice(fi, min(fi + n, n_frames))
        if kind == "v":
            voiced[sl] = True
            tgt = _VOWELS[rng.integers(len(_VOWELS))] * rng.uniform(0.9, 1.1, 3)
            # linear vowel-to-vowel glide within the segment (coarticulation
            # from wherever the tract was left)
            a = np.linspace(0.0, 1.0, sl.stop - sl.start, dtype=np.float32)[:, None]
            targets[sl] = last_target[None] * (1 - a) + tgt[None] * a
            last_target = tgt
            # segment intonation: gentle rise or fall
            f0_seg[sl] = rng.uniform(0.92, 1.08) * np.linspace(
                1.0, rng.uniform(0.9, 1.1), sl.stop - sl.start)
            energy[sl] = rng.uniform(0.6, 1.0)
        elif kind == "f":
            fric[sl] = True
            targets[sl] = last_target[None]
            energy[sl] = rng.uniform(0.15, 0.45)
        else:
            targets[sl] = last_target[None]
        fi += n
        if fi >= n_frames:
            break

    # utterance-level declination + vibrato + jitter
    decl = np.linspace(1.08, 0.86, n_frames).astype(np.float32)
    vib = 1.0 + rng.uniform(0.01, 0.03) * np.sin(
        2 * np.pi * rng.uniform(4.0, 7.0) * frame_t + rng.uniform(0, 2 * np.pi))
    jit = 1.0 + rng.normal(0.0, 0.008, n_frames).astype(np.float32)
    f0 = base_f0 * decl * vib * jit * np.where(f0_seg > 0, f0_seg, 1.0)
    f0 = np.clip(f0, 60.0, 400.0).astype(np.float32)

    targets = _smooth(targets, 5)  # coarticulation across segment joins
    bw = np.array([rng.uniform(60, 110), rng.uniform(90, 170),
                   rng.uniform(130, 260)], np.float32)

    # 10-30 ms attack/release ramps at voiced/fricative boundaries
    act = (voiced | fric).astype(np.float32) * energy
    act = np.convolve(act, np.ones(3, np.float32) / 3, "same").astype(np.float32)

    # ---- harmonic (voiced) part -----------------------------------------
    nyq = 0.45 * sample_rate
    K = min(80, int(nyq / 60.0))
    k = np.arange(1, K + 1, dtype=np.float32)
    hf = f0[:, None] * k[None]  # (frames, K) harmonic freqs
    env = _formant_envelope(hf, targets, np.broadcast_to(bw, (n_frames, 3)))
    tilt = 1.0 / (1.0 + (hf / 3500.0) ** 2)  # source tilt + radiation, net
    amp = env * tilt * (voiced[:, None] * act[:, None])
    amp[hf > nyq] = 0.0

    # per-sample interpolation of f0 and amplitudes
    tf = np.arange(L, dtype=np.float32) / hop
    i0 = np.clip(tf.astype(np.int64), 0, n_frames - 2)
    w = (tf - i0).astype(np.float32)[:, None]
    f0_s = (f0[i0] * (1 - w[:, 0]) + f0[i0 + 1] * w[:, 0])
    amp_s = amp[i0] * (1 - w) + amp[i0 + 1] * w  # (L, K)
    phase = 2 * np.pi * np.cumsum(f0_s) / sample_rate  # (L,)
    wav = np.sum(amp_s * np.sin(phase[:, None] * k[None]), axis=1)

    # ---- noise part (fricatives + aspiration) ---------------------------
    noise = rng.normal(0.0, 1.0, L).astype(np.float32)
    spec = np.fft.rfft(noise)
    fgrid = np.fft.rfftfreq(L, 1.0 / sample_rate).astype(np.float32)
    center = float(rng.uniform(2500.0, 7000.0))
    width = float(rng.uniform(800.0, 2500.0))
    bump = np.exp(-0.5 * ((fgrid - center) / width) ** 2)
    fric_wav = np.fft.irfft(spec * bump, n=L).astype(np.float32)
    fric_wav /= max(np.sqrt(np.mean(fric_wav ** 2)), 1e-6)

    fric_s = (fric.astype(np.float32) * act)[i0] * (1 - w[:, 0]) \
        + (fric.astype(np.float32) * act)[i0 + 1] * w[:, 0]
    asp_s = (voiced.astype(np.float32) * act)[i0] * (1 - w[:, 0]) \
        + (voiced.astype(np.float32) * act)[i0 + 1] * w[:, 0]
    wav = wav + 0.5 * fric_wav * fric_s \
        + float(rng.uniform(0.02, 0.08)) * fric_wav * asp_s

    rms = np.sqrt(np.mean(wav ** 2))
    wav = wav * (float(rng.uniform(0.08, 0.15)) / max(rms, 1e-6))
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def synthetic_speech_batch(rng: np.random.Generator, batch: int,
                           seconds: float, sample_rate: int = 24000
                           ) -> np.ndarray:
    return np.stack([synthesize_utterance(rng, seconds, sample_rate)
                     for _ in range(batch)])


def synthetic_speech_iter(seed: int, batch: int, seconds: float,
                          sample_rate: int = 24000) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_speech_batch(rng, batch, seconds, sample_rate)


# ------------------------- ABX-proxy eval metric -----------------------------

def _mel_filterbank(n_fft: int, sample_rate: int, n_mels: int = 40
                    ) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, n_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        if c > l:
            fb[m - 1, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[m - 1, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


def mcd_db(est: np.ndarray, ref: np.ndarray, sample_rate: int,
           n_fft: int = 1024, hop: int = 256, n_mfcc: int = 13) -> float:
    """Mel-cepstral distortion in dB (lower is better) — a standard
    perceptual ABX proxy for codec reconstruction, complementing SI-SNR
    (phase-sensitive) and raw mel distance."""
    from scipy.fftpack import dct

    def mcep(x):
        x = np.asarray(x, np.float32).reshape(-1)
        n = (len(x) - n_fft) // hop + 1
        if n < 1:
            return np.zeros((0, n_mfcc), np.float32)
        frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop]
        win = np.hanning(n_fft).astype(np.float32)
        mag = np.abs(np.fft.rfft(frames * win, axis=-1))
        mel = _mel_filterbank(n_fft, sample_rate) @ mag.T  # (n_mels, n)
        logmel = np.log(mel + 1e-5)
        return dct(logmel.T, type=2, norm="ortho")[:, 1:n_mfcc + 1]

    a, b = mcep(est), mcep(ref)
    n = min(len(a), len(b))
    if n == 0:
        return float("nan")
    d = a[:n] - b[:n]
    return float(np.mean((10.0 / np.log(10.0))
                         * np.sqrt(2.0 * np.sum(d * d, axis=1))))
