"""The W8A16 kernel's device time at the 8B shapes under each launch plan it
could take, on one NVIDIA GPU.

    python3 -m mosstts_tpu_torch.tools.w8a16_plans [--shapes wq wk ...] [--M 1 16]

For each ``kernel_inputs.GEMM_8B`` shape and row count M: the plan
``w8a16_plan`` picks, then each decode instantiation (M <= 16) or each
prefill one (M > 16) at every split of K over 1-8 blocks of a
cluster (whole k tiles, none empty; splits that reach the same plan are
timed once). Device ms per call from CUDA-graph replays
(``kernel_inputs.time_ms``) on the smoke's inputs: a 36-layer int8 stack
read one layer per call (cold in L2; ``--warm``: layer 0 every call) for
the backbone weights, the text head, the 32-head audio stack at
``QuantWeight``'s 16-byte row pitch; beside each its blocks and its
difference from the plain version (a reading, not a check). The card's
``nvidia-smi`` line first, one JSON object last.
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from ..ops import quant
from ..ops.kernels import w8_gemm
from .kernel_inputs import GEMM_8B, card_line, time_ms

L8 = 36


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=[g[0] for g in GEMM_8B])
    ap.add_argument("--M", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--warm", action="store_true",
                    help="every call reads layer 0 (warm in L2 where it fits): memory or instructions?")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    card = card_line()
    print(card, flush=True)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    real = w8_gemm.w8a16_plan
    g = torch.Generator(device="cuda").manual_seed(5)
    res = dict(card=card, rows=[])
    for name, K, N, count, out_dtype in GEMM_8B:
        if name not in args.shapes:
            continue
        L = 1 if count or name.endswith("head") else L8
        shape = ((count,) if count else (L,)) + (K, N)
        q = torch.empty(shape, dtype=torch.int8, device="cuda").random_(-127, 128, generator=g)
        sc = torch.rand(shape[:-2] + (N,), generator=g, device="cuda") * 0.019 + 0.001
        if count:
            w = quant.QuantWeight(q, sc)
            pick = (lambda i, w=w: (w.q, w.scale))
        else:
            layer = (lambda i: 0) if args.warm else (lambda i, L=L: i % L)
            pick = (lambda i, q=q, sc=sc, layer=layer: (q[layer(i)], sc[layer(i)]))
        for M in args.M:
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            chosen = real(M, K, N, count or 1, sm)
            ref = w8_gemm.w8a16_gemm_ref(x, *pick(0), torch.float32)
            variants = [v for v, spec in enumerate(w8_gemm.A16_VARIANTS)
                        if (spec[0] == 1) == (chosen.mt == 1)]
            seen = set()
            for v in variants:
                for s in range(1, w8_gemm.MAX_CLUSTER + 1):
                    plan = real(M, K, N, count or 1, sm, variant=v, splits=s)
                    if plan in seen:
                        continue
                    seen.add(plan)
                    w8_gemm.w8a16_plan = functools.partial(real, variant=v, splits=s)
                    w8_gemm._A16_PLANS.clear()
                    try:
                        out = w8_gemm.w8a16_gemm(x, *pick(0), torch.float32)
                        err = float((out - ref).abs().max() / ref.abs().max())
                        n = 36 if K * N * (count or 1) < 2e8 else 8
                        ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, *pick(i), out_dtype), n=n)
                    finally:
                        w8_gemm.w8a16_plan = real
                        w8_gemm._A16_PLANS.clear()
                    blocks = (plan.tiles * (count or 1) + plan.tail_blocks) * plan.row_tiles
                    row = dict(shape=f"{name} M={M}", variant=v, bn=plan.bn, splits=plan.splits,
                               blocks=blocks * plan.splits, ms=ms, rel_err=err,
                               chosen=plan == chosen)
                    res["rows"].append(row)
                    print(f"{name} M={M} variant {v} (BN {plan.bn}) splits {plan.splits}: "
                          f"{row['blocks']} blocks, {ms * 1e3:.2f} µs, max abs error "
                          f"{err:.1e} of the largest output"
                          f"{'  <- plan' if row['chosen'] else ''}", flush=True)
        del q, sc, pick
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
