"""Unified training driver for the three TTS model families.

Ports ``mosstts_tpu/train/trainer.py``: ``synthetic_tts_batch``,
``TTSTrainer`` (``train_step``, ``fit``, ``save``, ``save_state``,
``restore_state``) and ``main``. One trainer covers the Delay, Local and
Realtime families over their losses (``models.delay.delay_loss``,
``models.local.local_loss``, ``models.realtime.realtime_loss``):

* AdamW (weight decay 0.01) on a warmup-cosine schedule with global-norm
  clipping at 1.0, update for update as optax's (``train/optim.py``);
* one eager step per call: forward, backward (``torch.autograd``), clip,
  update in place. ``train_step`` reports the loss and the gradients'
  global norm before clipping, as the JAX trainer does;
* ``remat`` recomputes each transformer layer's activations in the
  backward pass (``nn/qwen3.py``);
* checkpoints: ``save`` writes the serving format (``utils/save.save_model``,
  ``model_type="moss_tts_<family>"``) and ``train_history.json``;
  ``save_state``/``restore_state`` the resumable train state
  (``train/checkpoint.py``).

The parameters are made trainable (``requires_grad_``): the families'
``init_*_params`` build frozen ones. The trainer runs on the card unless
the caller passes ``device="cpu"``. Real data loading is the caller's:
``fit`` consumes any iterator of batches ``{"input_ids", "attention_mask",
"labels"}`` shaped (B, T, C) (``train/data.py``'s ``BucketedLoader`` yields
them).

Parallel training (SPMD: every rank makes the same calls with the same
batches; ``parallel/mesh.py``):

* ``mesh=`` (``make_mesh``): the family's spec table shards the parameters
  on ``"model"`` (tensor parallelism); each ``"data"`` rank takes its block
  of the batch's rows, the loss sums and counts are summed over ``"data"``
  and so are the gradients, and the clipping norm counts every block once
  (``optim.sharded_global_norm``). The optimizer moments are the shards'.
* ``pipeline=(make_pp_mesh(S[, model]), n_micro)`` (Delay only, as in
  JAX): each rank holds its stage's layers (and its ``"model"`` block
  of them), and the loss runs through ``delay_forward(pipeline=)``.
* ``save_state``/``restore_state`` write and read per rank: each rank its
  blocks, rank 0 the replicated tensors and the step.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import DelayConfig, LocalConfig, RealtimeConfig
from ..models.delay import delay_loss, init_delay_params
from ..models.local import init_local_params, local_loss
from ..models.realtime import init_realtime_params, realtime_loss
from ..ops.collectives import axis_of, reduce, sharded_dims
from .optim import AdamW, value_and_grad, warmup_cosine

_FAMILIES = {
    "delay": (init_delay_params, DelayConfig),
    "local": (init_local_params, LocalConfig),
    "realtime": (init_realtime_params, RealtimeConfig),
}
WEIGHT_DECAY, CLIP_NORM = 0.01, 1.0


def synthetic_tts_batch(family: str, cfg, rng: np.random.Generator,
                        batch: int = 2, seq: int = 24) -> Dict[str, np.ndarray]:
    """Ports ``mosstts_tpu.train.trainer.synthetic_tts_batch``: a short
    "prompt" region (labels -100) followed by valid audio frames, the same
    numpy draws as JAX's from the same generator."""
    C = cfg.channels
    n_audio = C - 1
    text_vocab = cfg.language_config.vocab_size
    audio_hi = (cfg.audio_vocab_size if family == "realtime"
                else cfg.audio_pad_code)

    ids = np.zeros((batch, seq, C), np.int32)
    ids[..., 0] = rng.integers(0, text_vocab, (batch, seq))
    ids[..., 1:] = rng.integers(0, 1024, (batch, seq, n_audio))
    labels = np.full((batch, seq, C), -100, np.int64)
    prompt = seq // 3
    labels[:, prompt:, 0] = ids[:, prompt:, 0]
    labels[:, prompt:, 1:] = np.minimum(ids[:, prompt:, 1:], audio_hi - 1)
    mask = np.ones((batch, seq), bool)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


class TTSTrainer:
    """Ports ``mosstts_tpu.train.trainer.TTSTrainer``: owns the parameters
    (a trainable ``DelayParams``/``LocalParams``/``RealtimeParams`` on
    ``device``), the optimizer and the step count of a model family
    ('delay' | 'local' | 'realtime')."""

    def __init__(self, family: str, cfg, *, seed: int = 0,
                 peak_lr: float = 1e-4, warmup_steps: int = 100,
                 total_steps: int = 10_000, dtype=torch.float32,
                 mesh=None, channel_weights=None, remat: bool = False,
                 pipeline=None, device="cuda"):
        if family not in _FAMILIES:
            raise ValueError(f"unknown family {family!r}; pick from {sorted(_FAMILIES)}")
        if pipeline is not None and family != "delay":
            raise ValueError("pipeline= is supported for the delay family")
        if pipeline is not None and mesh is not None:
            raise ValueError("pass mesh= or pipeline=, not both (a pipeline mesh may hold "
                             "a 'model' axis)")
        init_fn, _ = _FAMILIES[family]
        self.family = family
        self.cfg = cfg
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_fn(cfg, generator=gen, dtype=dtype, device=self.device)
        self.mesh, self.pipeline = mesh, pipeline
        if mesh is not None or pipeline is not None:
            from ..parallel import mesh as pm

            specs = {"delay": pm.delay_param_specs, "local": pm.local_param_specs,
                     "realtime": pm.realtime_param_specs}[family]()
            if pipeline is not None:
                specs = pipeline_specs(specs, pipeline[0].mesh_dim_names)
            pm.shard_params(self.params, mesh if mesh is not None else pipeline[0], specs)
        self.params.requires_grad_(True)
        self.opt = AdamW(dict(self.params.named_parameters()),
                         warmup_cosine(peak_lr, warmup_steps, total_steps),
                         weight_decay=WEIGHT_DECAY, clip_norm=CLIP_NORM)
        if self.sharded:
            self.opt.replicas = self._replicas()
        self.step_idx = 0
        self.history: List[Dict[str, float]] = []
        self.remat = bool(remat)
        self.channel_weights = (None if channel_weights is None else torch.as_tensor(
            np.asarray(channel_weights, np.float32), device=self.device))

    @property
    def sharded(self) -> bool:
        """Whether the parameters are sharded over a mesh (``mesh=`` or
        ``pipeline=``)."""
        return self.mesh is not None or self.pipeline is not None

    def _replicas(self) -> Dict[str, int]:
        """name -> the number of ranks holding the same block of it."""
        world = dist.get_world_size()
        axes = getattr(self.params, "_mesh_axes", {})
        out = {}
        for mod_name, mod in self.params.named_modules():
            for name, _ in mod.named_parameters(recurse=False):
                split = 1
                for axis in sharded_dims(mod, name).values():
                    split *= axes[axis].size
                out[f"{mod_name}.{name}" if mod_name else name] = world // split
        return out

    def sharded_names(self) -> List[str]:
        """The parameters split over an axis of the mesh (each rank holds
        its own block of them)."""
        return [n for n, r in self._replicas().items() if r < dist.get_world_size()]

    def loss(self, params, b: Dict[str, torch.Tensor]):
        """The family's loss of ``params`` on a batch of tensors: (loss, aux)."""
        args = (params, self.cfg, b["input_ids"], b["attention_mask"], b["labels"])
        if self.family == "delay":
            return delay_loss(*args, channelwise_loss_weight=self.channel_weights,
                              remat=self.remat, pipeline=self.pipeline)
        if self.family == "local":
            return local_loss(*args, channel_weights=self.channel_weights, remat=self.remat)
        return realtime_loss(*args, remat=self.remat)

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One step: forward, backward, clip, update. Returns {"step",
        "loss", "grad_norm"} (the norm before clipping)."""
        b = {k: np.asarray(v) for k, v in batch.items()}
        data = axis_of(self.params, "data")
        if data is not None:  # this rank's block of the rows
            B = len(b["input_ids"])
            if B % data.size:
                raise ValueError(f"batch {B} not divisible by mesh data axis {data.size}")
            n = B // data.size
            b = {k: v[data.index * n:(data.index + 1) * n] for k, v in b.items()}
        b = {k: torch.as_tensor(v, device=self.device) for k, v in b.items()}
        loss, _, grads = value_and_grad(self.params, lambda p: self.loss(p, b))
        if data is not None:  # the global loss' gradient: every rank's share summed
            grads = {k: reduce(g, data) for k, g in grads.items()}
        gnorm = self.opt.step(grads)
        rec = {"step": self.step_idx, "loss": float(loss), "grad_norm": float(gnorm)}
        self.step_idx += 1
        self.history.append(rec)
        return rec

    def fit(self, data: Iterator[Dict[str, np.ndarray]], steps: int,
            log_every: int = 10,
            log_fn: Callable[[str], None] = print) -> List[Dict[str, float]]:
        t0 = time.perf_counter()
        for _ in range(steps):
            rec = self.train_step(next(data))
            if rec["step"] % log_every == 0:
                rate = (rec["step"] + 1) / (time.perf_counter() - t0)
                log_fn(f"{self.family}-train step {rec['step']}: "
                       f"loss={rec['loss']:.4f} |g|={rec['grad_norm']:.3f} "
                       f"({rate:.2f} steps/s)")
        return self.history

    def save_state(self, path, *, use_async: bool = False):
        """The resumable train state (parameters, optimizer moments, step):
        ``train/checkpoint.py``. ``save`` writes only the model, in the
        serving format."""
        from .checkpoint import save_train_state

        return save_train_state(path, self, use_async=use_async)

    def restore_state(self, path) -> "TTSTrainer":
        from .checkpoint import restore_train_state

        restore_train_state(path, self)
        return self

    def save(self, path) -> None:
        """The model in the serving format (``utils/save.save_model``; the
        serving loaders' ``model_type`` names) and ``train_history.json``."""
        from ..utils.save import save_model

        if self.sharded:
            raise ValueError("save() writes the whole model; a sharded trainer saves per rank "
                             "with save_state()")
        save_model(path, self.params, self.cfg, f"moss_tts_{self.family}")
        with open(str(path) + "/train_history.json", "w") as f:
            json.dump(self.history, f)


def pipeline_specs(specs: dict, mesh_dims) -> dict:
    """A family's spec table for a pipeline mesh: the backbone's layer
    stacks split on ``"stage"`` along the layer dimension, and on
    ``"model"`` as the table says when the mesh has that axis (else nothing
    else is split)."""
    tp = "model" in mesh_dims

    def walk(node, in_layers):
        if isinstance(node, dict):
            return {k: walk(v, in_layers or k == "layers") for k, v in node.items()}
        spec = node if tp else tuple(None for _ in node)
        if in_layers:
            spec = ("stage",) + tuple(spec[1:]) if spec else ("stage",)
        return spec

    return walk(specs, False)


def tiny_config(family: str):
    """The JAX CLI's small configuration of each family."""
    from ..core.config import RealtimeLocalConfig, tiny_qwen3

    tiny = tiny_qwen3()
    if family == "delay":
        return DelayConfig(language_config=tiny, n_vq=4)
    if family == "local":
        return LocalConfig(language_config=tiny, n_vq=4, additional_mlp_ffn_hidden_size=32,
                           local_ffn_hidden_size=48, local_hidden_size=24, local_num_layers=2)
    return RealtimeConfig(
        language_config=tiny_qwen3(hidden_size=32, num_attention_heads=2,
                                   num_key_value_heads=2, head_dim=16, intermediate_size=64),
        local_config=RealtimeLocalConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2, head_dim=16,
            rvq=4, max_position_embeddings=5),
        rvq=4)


def main(argv=None):
    """``python -m mosstts_tpu_torch.train.trainer``: train a family's small
    configuration on synthetic batches; the last line is {"first_loss",
    "last_loss"}. ``--mesh DATAxMODEL`` shards it over a mesh: run it under
    ``torchrun --nproc-per-node DATA*MODEL`` (every rank draws the same
    batches; rank 0 prints)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Train a TTS family on synthetic batches (smoke driver; "
                    "pass your own data iterator to TTSTrainer.fit for real "
                    "training).")
    ap.add_argument("--family", choices=sorted(_FAMILIES), default="delay")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=24)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--mesh", default=None,
                    help="'DATAxMODEL', e.g. 2x4: shard over a device mesh (under torchrun)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer's activations in the backward pass")
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = tiny_config(args.family)
    mesh = None
    if args.mesh:
        from ..parallel.mesh import make_mesh

        d, m = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(data=d, model=m, device="cuda" if args.device == "cuda" else "cpu")
        if args.device == "cuda":  # this rank's card
            args.device = f"cuda:{torch.cuda.current_device()}"
    trainer = TTSTrainer(args.family, cfg, peak_lr=args.lr,
                         warmup_steps=max(1, args.steps // 10),
                         total_steps=args.steps, mesh=mesh, remat=args.remat,
                         device=args.device)
    log = print if mesh is None or dist.get_rank() == 0 else (lambda *a: None)
    rng = np.random.default_rng(0)

    def data():
        while True:
            yield synthetic_tts_batch(args.family, cfg, rng, batch=args.batch, seq=args.seq)

    hist = trainer.fit(data(), args.steps, log_fn=log)
    if args.save:
        trainer.save(args.save)
    log(json.dumps({"first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"]}))
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
