"""Where greedy grids from the continuous-batching server part from the solo
engine's, at MOSS-TTS 8B width on the card.

Four random greedy prompts (70-150 rows ending in the gen-slot token) go
through a 16-slot ``DelayBatchServer`` at once and then each alone, and
through ``DelayEngine.generate`` at batch 1, on the prompt as it is and
left-padded to the server's 32-row prompt bucket, on bf16 and then int8
weights. Prints, per request, the first generated frame at which two grids
differ (None: equal over all frames):

    python3 -m mosstts_tpu_torch.tools.pool_vs_solo [--new 64]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.config import delay_8b
from ..engine.batch_server import DelayBatchServer
from ..engine.delay_engine import DelayEngine
from ..models.delay import make_sampling
from .kernel_inputs import card_line


def first_divergence(a, b):
    """The first generated frame at which (start, grid) pairs a and b
    differ, or None."""
    (sa, ga), (sb, gb) = a, b
    ga, gb = ga[sa:], gb[sb:]
    n = min(len(ga), len(gb))
    d = np.nonzero((ga[:n] != gb[:n]).any(axis=1))[0]
    return int(d[0]) if len(d) else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--new", type=int, default=64, help="new frames per request")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pool_vs_solo measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    cfg = delay_8b()
    engine = DelayEngine.random_init(seed=0, config=cfg, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    grids = []
    for T in (70, 90, 120, 150):
        g = rng.integers(0, 1000, (T, cfg.channels))
        g[:, 1:] = rng.integers(0, 1024, (T, cfg.n_vq))
        g[-1, 0] = cfg.audio_assistant_gen_slot_token_id
        grids.append(g)
    greedy = dict(text_temperature=0.0, audio_temperature=0.0)

    def padded(g, bucket=32):
        T, Tb = len(g), -(-len(g) // bucket) * bucket
        ids = np.full((1, Tb, cfg.channels), cfg.audio_pad_code, np.int64)
        ids[..., 0] = cfg.pad_token_id
        ids[0, Tb - T:] = g
        mask = np.zeros((1, Tb), bool)
        mask[0, Tb - T:] = True
        return ids, mask

    for weights in ("bf16", "int8"):
        if weights == "int8":
            engine.quantize()
        server = DelayBatchServer(engine.params, cfg, slots=16, cache_len=1024,
                                  out_capacity=256, prompt_bucket=32,
                                  sampling=make_sampling(**greedy, device="cuda"))
        rids = [server.submit(g, max_new_tokens=args.new) for g in grids]
        together = {c.request_id: (c.start_length, c.tokens) for c in server.run()}
        for i, g in enumerate(grids):
            server.submit(g, max_new_tokens=args.new)
            c = server.run()[0]
            alone = (c.start_length, c.tokens)
            pool = together[rids[i]]
            solo = engine.generate(g[None], max_new_tokens=args.new, **greedy)[0]
            solo_padded = engine.generate(*padded(g), max_new_tokens=args.new, **greedy)[0]
            print(f"{weights} request {i} ({len(g)} rows): first differing frame of {args.new}: "
                  f"together vs alone {first_divergence(pool, alone)}, together vs solo "
                  f"{first_divergence(pool, solo)}, together vs solo on the padded prompt "
                  f"{first_divergence(pool, solo_padded)}, solo padded vs unpadded "
                  f"{first_divergence(solo_padded, solo)}", flush=True)
        del server


if __name__ == "__main__":
    main()
