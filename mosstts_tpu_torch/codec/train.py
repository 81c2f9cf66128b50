"""Codec training driver: optimizer, schedule, the reconstruction and the
adversarial step, evaluation and checkpoints.

Ports ``mosstts_tpu/codec/train.py``: ``si_snr``, ``si_snr_shifted``,
``mel_distance``, ``synthetic_audio_batch``, ``synthetic_data_iter``,
``make_codec_optimizer``, ``CodecTrainer`` (``train_step``, ``fit``,
``evaluate``, ``tokenizer``, ``save``) and ``main``. A step is eager:
the reconstruction step (``codec/losses.codec_loss``), or with
``adversarial=True`` one generator update (reconstruction plus the hinge
and feature-matching terms against the frozen discriminators, gated by
``adv_on`` from step ``adv_start``) then one discriminator update (hinge
real/fake on the generator's detached output), as JAX's fused step does.
The optimizers (``train/optim.py``) are optax's AdamW or Adafactor behind
a global-norm clip, on the warmup-cosine schedule. The trainer runs on the
card unless the caller passes ``device="cpu"``.

CLI smoke (synthetic audio):
    python -m mosstts_tpu_torch.codec.train --steps 50 --hidden 64
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import CodecConfig
from ..train.optim import AdamW, Adafactor, value_and_grad, warmup_cosine
from .discriminator import (disc_forward, feature_matching_loss, hinge_d_loss, hinge_g_loss,
                            init_discriminators)
from .losses import codec_forward_train, codec_loss, reconstruction_terms, stft_mag
from .model import MossAudioTokenizer, init_codec_params


# ------------------------------ quality metrics ------------------------------

def si_snr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Ports ``si_snr``: scale-invariant SNR in dB (float64 numpy)."""
    est = np.asarray(est, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    n = min(est.size, ref.size)
    est, ref = est[:n], ref[:n]
    ref_zm = ref - ref.mean()
    est_zm = est - est.mean()
    proj = (est_zm @ ref_zm) / (ref_zm @ ref_zm + eps) * ref_zm
    noise = est_zm - proj
    return float(10.0 * np.log10((proj @ proj + eps) / (noise @ noise + eps)))


def si_snr_shifted(est: np.ndarray, ref: np.ndarray, sample_rate: int = 24000,
                   max_shift_ms: float = 5.0) -> Tuple[float, int]:
    """Ports ``si_snr_shifted``: SI-SNR maximized over integer delays up to
    ``max_shift_ms``. Returns (best dB, shift in samples; positive = est
    lags ref)."""
    est = np.asarray(est, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    n = min(est.size, ref.size)
    est, ref = est[:n], ref[:n]
    m = max(1, int(max_shift_ms * sample_rate / 1000.0))
    best_db, best_k = -np.inf, 0
    for k in range(-m, m + 1):
        if k >= 0:
            e, r = est[k:], ref[: n - k]
        else:
            e, r = est[: n + k], ref[-k:]
        db = si_snr(e, r)
        if db > best_db:
            best_db, best_k = db, k
    return float(best_db), int(best_k)


def mel_distance(est: np.ndarray, ref: np.ndarray, frame: int = 1024, hop: int = 256) -> float:
    """Ports ``mel_distance``: the log-magnitude STFT L1 distance (float32,
    on the CPU)."""
    est = torch.as_tensor(np.asarray(est, np.float32).reshape(1, -1))
    ref = torch.as_tensor(np.asarray(ref, np.float32).reshape(1, -1))
    n = min(est.shape[1], ref.shape[1])
    me, mr = stft_mag(est[:, :n], frame, hop), stft_mag(ref[:, :n], frame, hop)
    return float((torch.log(me + 1e-5) - torch.log(mr + 1e-5)).abs().mean())


# ------------------------------ synthetic data -------------------------------

def synthetic_audio_batch(rng: np.random.Generator, batch: int, seconds: float,
                          sample_rate: int = 24000) -> np.ndarray:
    """Ports ``synthetic_audio_batch``: band-limited harmonic-plus-noise
    mixtures, the same numpy draws as JAX's from the same generator."""
    L = int(seconds * sample_rate)
    t = np.arange(L, dtype=np.float32) / sample_rate
    out = np.zeros((batch, L), np.float32)
    for b in range(batch):
        f0 = rng.uniform(80.0, 400.0)
        sig = np.zeros(L, np.float32)
        for h in range(1, 6):
            amp = rng.uniform(0.05, 0.4) / h
            sig += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t))
        sig = sig * env.astype(np.float32)
        sig += rng.normal(0, 0.01, L).astype(np.float32)
        out[b] = sig
    return out


def synthetic_data_iter(seed: int, batch: int, seconds: float,
                        sample_rate: int = 24000) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_audio_batch(rng, batch, seconds, sample_rate)


# -------------------------------- the trainer --------------------------------

def make_codec_optimizer(params: Dict[str, torch.Tensor], peak_lr: float = 3e-4,
                         warmup_steps: int = 500, total_steps: int = 100_000,
                         weight_decay: float = 1e-4, clip_norm: float = 1.0,
                         kind: str = "adamw"):
    """Ports ``make_codec_optimizer`` over ``params`` (name -> parameter):
    global-norm clip, then AdamW or (``kind="adafactor"``) Adafactor (no
    first moment, factored second moments), on the warmup-cosine
    schedule."""
    lr = warmup_cosine(peak_lr, warmup_steps, total_steps)
    if kind == "adafactor":
        return Adafactor(params, lr, weight_decay=weight_decay, clip_norm=clip_norm)
    if kind != "adamw":
        raise ValueError(f"unknown optimizer {kind!r}: adamw or adafactor")
    return AdamW(params, lr, weight_decay=weight_decay, clip_norm=clip_norm)


class CodecTrainer:
    """Ports ``mosstts_tpu.codec.train.CodecTrainer``: owns the trainable
    codec parameters (and with ``adversarial`` the discriminators), their
    optimizers and the step count; logs per-step losses."""

    def __init__(self, cfg: CodecConfig, *, seed: int = 0,
                 num_quantizers: Optional[int] = None,
                 peak_lr: float = 3e-4, warmup_steps: int = 500,
                 total_steps: int = 100_000, dtype=torch.float32,
                 snr_weight: float = 1.0, lag_tolerance: int = 0,
                 adversarial: bool = False,
                 adv_weight: float = 3.0, fm_weight: float = 3.0,
                 disc_lr: float = 3e-4, disc_channels: int = 32,
                 adv_start: int = 0, optimizer: str = "adamw", device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_quantizers = int(num_quantizers or cfg.n_q)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_codec_params(cfg, generator=gen, dtype=dtype, device=self.device)
        self.params.requires_grad_(True)
        self.opt = make_codec_optimizer(dict(self.params.named_parameters()), peak_lr,
                                        warmup_steps, total_steps, kind=optimizer)
        self.step_idx = 0
        self.history: List[Dict[str, float]] = []
        self.snr_weight, self.lag_tolerance = float(snr_weight), int(lag_tolerance)
        self.adversarial = bool(adversarial)
        self.adv_start = int(adv_start)
        self.adv_weight, self.fm_weight = float(adv_weight), float(fm_weight)
        if self.adversarial:
            dgen = torch.Generator(device=self.device).manual_seed(seed + 1)
            self.d_params = init_discriminators(generator=dgen, channels=disc_channels,
                                                device=self.device)
            self.d_params.requires_grad_(True)
            self.d_opt = make_codec_optimizer(dict(self.d_params.named_parameters()), disc_lr,
                                              warmup_steps, total_steps)

    def _gan_step(self, wav: torch.Tensor, adv_on: float):
        """One generator update (discriminators frozen), then one
        discriminator update on the generator's detached output."""
        cfg, nq = self.cfg, self.num_quantizers

        def g_loss_fn(p):
            recon, q_aux = codec_forward_train(p, cfg, wav, nq)
            reconf, target, l1, spec, neg_snr = reconstruction_terms(recon, wav,
                                                                     self.lag_tolerance)
            fake_outs = disc_forward(self.d_params, reconf)
            real_outs = disc_forward(self.d_params, target.detach())
            adv = hinge_g_loss(fake_outs)
            fm = feature_matching_loss(real_outs, fake_outs)
            total = (l1 + spec + self.snr_weight * neg_snr
                     + 0.25 * q_aux["commitment"] + q_aux["codebook"]
                     + adv_on * (self.adv_weight * adv + self.fm_weight * fm))
            return total, {"l1": l1, "stft": spec, "neg_si_snr_db": neg_snr, "adv": adv,
                           "fm": fm, **q_aux, "_fake": reconf, "_real": target}

        loss, metrics, grads = value_and_grad(self.params, g_loss_fn)
        self.opt.step(grads)
        del grads  # before the discriminator's pass
        fake, real = metrics.pop("_fake"), metrics.pop("_real")
        d_loss, _, d_grads = value_and_grad(self.d_params, lambda dp: (hinge_d_loss(
            disc_forward(dp, real), disc_forward(dp, fake)), {}))
        self.d_opt.step(d_grads)
        metrics["d_loss"] = d_loss
        return loss, metrics

    def train_step(self, wav: np.ndarray) -> Dict[str, float]:
        """One step on a (B, L) batch; returns {"step", "loss", and each
        term}."""
        w = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)
        if self.adversarial:
            loss, aux = self._gan_step(w, 1.0 if self.step_idx >= self.adv_start else 0.0)
        else:
            loss, aux, grads = value_and_grad(self.params, lambda p: codec_loss(
                p, self.cfg, w, num_quantizers=self.num_quantizers,
                snr_weight=self.snr_weight, lag_tolerance=self.lag_tolerance))
            self.opt.step(grads)
        rec = {"step": self.step_idx, "loss": float(loss)}
        rec.update({k: float(v) for k, v in aux.items()})
        self.step_idx += 1
        self.history.append(rec)
        return rec

    def fit(self, data: Iterator[np.ndarray], steps: int, log_every: int = 10,
            log_fn: Callable[[str], None] = print) -> List[Dict[str, float]]:
        t0 = time.perf_counter()
        for _ in range(steps):
            rec = self.train_step(next(data))
            if rec["step"] % log_every == 0:
                rate = (rec["step"] + 1) / (time.perf_counter() - t0)
                log_fn(f"codec-train step {rec['step']}: loss={rec['loss']:.4f} "
                       f"l1={rec['l1']:.4f} stft={rec['stft']:.4f} "
                       f"commit={rec['commitment']:.4f} ({rate:.2f} steps/s)")
        return self.history

    # ------------------------------ evaluation ------------------------------
    def evaluate(self, wav: np.ndarray) -> Dict[str, float]:
        """Ports ``CodecTrainer.evaluate``: the inference path's round trip
        (encode, decode in one chunk) scored by SI-SNR, the shift-tolerant
        SI-SNR and its shift, the log-STFT distance and the mel-cepstral
        distortion."""
        from .speech_synth import mcd_db

        codec = self.tokenizer()
        codes = codec.batch_encode([w for w in wav], num_quantizers=self.num_quantizers)
        recon = np.asarray(codec.decode(codes.audio_codes, chunk_duration=None).audio)[:, 0]
        n = min(recon.shape[1], wav.shape[1])
        rows = range(wav.shape[0])
        sr = self.cfg.sampling_rate
        shifted = [si_snr_shifted(recon[b, :n], wav[b, :n], sr) for b in rows]
        return {
            "si_snr_db": float(np.mean([si_snr(recon[b, :n], wav[b, :n]) for b in rows])),
            "si_snr_shift_db": float(np.mean([d for d, _ in shifted])),
            "shift_samples": float(np.median([k for _, k in shifted])),
            "mel_dist": float(np.mean([mel_distance(recon[b, :n], wav[b, :n]) for b in rows])),
            "mcd_db": float(np.mean([mcd_db(recon[b, :n], wav[b, :n], sr) for b in rows])),
        }

    def tokenizer(self) -> MossAudioTokenizer:
        return MossAudioTokenizer(self.params, self.cfg)

    def save(self, path) -> None:
        """The codec directory (``save_pretrained``) and
        ``train_history.json``."""
        self.tokenizer().save_pretrained(path)
        with open(str(path) + "/train_history.json", "w") as f:
            json.dump(self.history, f)


def main(argv=None):
    """``python -m mosstts_tpu_torch.codec.train``: train a small codec on
    synthetic audio; the last line is {"before", "after"} (``evaluate``)."""
    import argparse

    ap = argparse.ArgumentParser(description="Train the codec on synthetic audio (smoke).")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--n-q", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lag-tol", type=int, default=0,
                    help="waveform-loss lag tolerance in samples (0 = strict alignment)")
    ap.add_argument("--snr-weight", type=float, default=1.0,
                    help="weight of the differentiable -SI-SNR term")
    ap.add_argument("--adversarial", action="store_true",
                    help="the GAN half: MS-STFT and multi-period discriminators, hinge "
                         "losses, feature matching (alternating G/D updates)")
    ap.add_argument("--adv-weight", type=float, default=3.0)
    ap.add_argument("--fm-weight", type=float, default=3.0)
    ap.add_argument("--adv-start", type=int, default=0,
                    help="step at which the adversarial terms switch on")
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = CodecConfig(
        hidden_size=args.hidden, intermediate_size=args.hidden * 3,
        num_encoder_layers=args.layers, num_decoder_layers=args.layers,
        num_attention_heads=max(2, args.hidden // 32),
        num_key_value_heads=max(2, args.hidden // 32),
        head_dim=32, n_q=args.n_q, codebook_dim=min(64, args.hidden),
    )
    trainer = CodecTrainer(cfg, num_quantizers=args.n_q, peak_lr=args.lr,
                           warmup_steps=max(1, args.steps // 10),
                           total_steps=args.steps, snr_weight=args.snr_weight,
                           lag_tolerance=args.lag_tol, adversarial=args.adversarial,
                           adv_weight=args.adv_weight, fm_weight=args.fm_weight,
                           adv_start=args.adv_start, device=args.device)
    data = synthetic_data_iter(0, args.batch, args.seconds, cfg.sampling_rate)
    eval_wav = synthetic_audio_batch(np.random.default_rng(99), 2, args.seconds,
                                     cfg.sampling_rate)
    before = trainer.evaluate(eval_wav)
    trainer.fit(data, args.steps)
    after = trainer.evaluate(eval_wav)
    if args.save:
        trainer.save(args.save)
    print(json.dumps({"before": before, "after": after}))


if __name__ == "__main__":
    main()
