"""Peak device memory and step time of the full-width trainers by batch, with
remat off and on, on one GPU.

    python3 -m mosstts_tpu_torch.tools.train_memory [--family local realtime delay]
        [--batch 2 4 5] [--seq 256]

For each family (Local 1.7B and Realtime 1.7B at full depth, Delay at 8B
width with 4 of its 36 layers, as ``chip_smoke.py`` phase 12 trains them;
float32, AdamW) and each batch: two steps on one synthetic batch with remat
off, then two with it on, each run's peak ``torch.cuda.max_memory_allocated``
and its second step's time, or "out of memory" where the card runs out.
One JSON line per run, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import numpy as np
import torch

from ..core.config import LocalConfig, RealtimeConfig, delay_8b, qwen3_1p7b, qwen3_8b
from ..train.trainer import TTSTrainer, synthetic_tts_batch
from .kernel_inputs import card_line

CONFIGS = {
    "local": lambda: LocalConfig(language_config=qwen3_1p7b(), n_vq=32),
    "realtime": RealtimeConfig,
    "delay": lambda: dataclasses.replace(delay_8b(),
                                         language_config=qwen3_8b(num_hidden_layers=4)),
}


def run(trainer, batch, remat: bool) -> dict:
    trainer.remat = remat
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rec = trainer.train_step(batch)
        step_s = time.perf_counter() - t  # the step ends in the host reading its loss
    except torch.OutOfMemoryError:
        return dict(remat=remat, out_of_memory=True)
    return dict(remat=remat, peak_gb=torch.cuda.max_memory_allocated() / 1e9, step_s=step_s,
                loss=rec["loss"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", nargs="+", default=sorted(CONFIGS), choices=sorted(CONFIGS))
    ap.add_argument("--batch", nargs="+", type=int, default=[2, 4, 5])
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("train_memory measures a GPU; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for family in args.family:
        cfg = CONFIGS[family]()
        trainer = TTSTrainer(family, cfg, peak_lr=1e-4, warmup_steps=1, total_steps=100,
                             device="cuda")
        for B in args.batch:
            batch = synthetic_tts_batch(family, cfg, np.random.default_rng(0), batch=B,
                                        seq=args.seq)
            for remat in (False, True):
                print(json.dumps(dict(family=family, batch=B, seq=args.seq,
                                      **run(trainer, batch, remat))), flush=True)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    print(card_line())


if __name__ == "__main__":
    main()
