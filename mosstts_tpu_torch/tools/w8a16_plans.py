"""The int8-weight GEMM kernel's device time under each launch plan it
could take, on one NVIDIA GPU.

    python3 -m mosstts_tpu_torch.tools.w8a16_plans [--shapes wq wk ...] [--M 1 16]
    python3 -m mosstts_tpu_torch.tools.w8a16_plans --mode w8a8 [--M 128]
    python3 -m mosstts_tpu_torch.tools.w8a16_plans --mode int4 [--M 64]
    python3 -m mosstts_tpu_torch.tools.w8a16_plans --mode f32x3 [--M 200 100 1]

For each shape and row count M: the plan ``gemm_plan`` picks, then each
of the mode's decode instantiations (M <= 16) or each prefill one (M > 16)
at every split of K over 1-8 blocks of a cluster (whole k tiles, none
empty; splits that reach the same plan are timed once). Device ms per call
from CUDA-graph replays (``kernel_inputs.time_ms``). W8A16 (the default)
on the smoke's inputs at the 8B shapes (``kernel_inputs.GEMM_8B``): a
36-layer int8 stack read one layer per call (cold in L2; ``--warm``:
layer 0 every call) for the backbone weights, the text head, the 32-head
audio stack at ``QuantWeight``'s 16-byte row pitch. W8A8 and int4 on their
tools' inputs (``tools/tune_mm8.py``: 16 layers of (4096, 12288), B=128;
``tools/probe_int4.py``: 16 packed layers of (2048, 12288), B=64), call i
reading layer i % 16 (``--warm``: layer 0); W8A8's time includes its row
quantization. F32X3 (``w8f32_gemm``) at ``codec_1p6b()``'s encoder shapes
(``kernel_inputs.codec_f32_shapes``), 22 layers (the encoder's) read in
turn (``--warm``: layer 0), float32 x at M = 200, 100 (the encoder's
100-frame chunks of one and two waves), 50, 12 and 1, the prologue launch
that writes x's terms in the time. Beside each plan its blocks and its
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
from .kernel_inputs import GEMM_8B, card_line, codec_f32_shapes, time_ms

L8 = 36
L_CODEC = 22  # codec_1p6b()'s encoder layers
MODES = {"w8a16": w8_gemm.W8A16, "w8a8": w8_gemm.W8A8, "int4": w8_gemm.INT4,
         "f32x3": w8_gemm.F32X3}


def _products(mode: int, args, g):
    """(name, K, N, count, M list, call(x, i), plain(x), x of M) per shape."""
    if mode == w8_gemm.F32X3:
        for name, K, N in codec_f32_shapes():
            q = torch.empty((L_CODEC, K, N), dtype=torch.int8, device="cuda").random_(
                -127, 128, generator=g)
            sc = torch.rand((L_CODEC, N), generator=g, device="cuda") * 0.019 + 0.001
            layer = (lambda i: 0) if args.warm else (lambda i: i % L_CODEC)
            yield (name, K, N, 1, args.M or [200, 100, 50, 12, 1],
                   lambda x, i, q=q, sc=sc, layer=layer: w8_gemm.w8f32_gemm(x, q[layer(i)],
                                                                            sc[layer(i)]),
                   lambda x, q=q, sc=sc: w8_gemm.w8a16_gemm_ref(x, q[0], sc[0], torch.float32),
                   lambda M, K=K: torch.randn((M, K), generator=g, device="cuda"))
            del q, sc
            torch.cuda.empty_cache()
        return
    if mode != w8_gemm.W8A16:
        from . import probe_int4, tune_mm8

        if mode == w8_gemm.W8A8:
            x0, w8, scale = tune_mm8.make_inputs(128, 16, 4096, 12288)
            layer = (lambda i: 0) if args.warm else (lambda i: i % 16)
            yield ("w8a8", 4096, 12288, 1, args.M or [128],
                   lambda x, i: w8_gemm.w8a8_gemm(x, w8[layer(i)], scale[layer(i)]),
                   lambda x: w8_gemm.w8a8_gemm_ref(x, w8[0], scale[0]),
                   lambda M: torch.randn((M, 4096), generator=g, device="cuda").to(torch.bfloat16))
        else:
            _, _, packed = probe_int4.make_inputs()
            layer = (lambda i: 0) if args.warm else (lambda i: i % 16)
            yield ("int4", 2048, 12288, 1, args.M or [64],
                   lambda x, i: w8_gemm.int4_gemm(x, packed[layer(i)]),
                   lambda x: w8_gemm.int4_gemm_ref(x, packed[0]),
                   lambda M: torch.randn((M, 4096), generator=g, device="cuda").to(torch.bfloat16))
        return
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
        yield (name, K, N, count or 1, args.M or [1, 16],
               lambda x, i, pick=pick, od=out_dtype: w8_gemm.w8a16_gemm(x, *pick(i), od),
               lambda x, pick=pick: w8_gemm.w8a16_gemm_ref(x, *pick(0), torch.float32),
               lambda M, K=K: torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16))
        del q, sc, pick
        torch.cuda.empty_cache()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="w8a16")
    ap.add_argument("--shapes", nargs="+", default=[g[0] for g in GEMM_8B],
                    help="W8A16: the GEMM_8B products to time")
    ap.add_argument("--M", type=int, nargs="+", default=None,
                    help="row counts (default: W8A16 1 16, W8A8 128, int4 64)")
    ap.add_argument("--warm", action="store_true",
                    help="every call reads layer 0 (warm in L2 where it fits): memory or instructions?")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    card = card_line()
    print(card, flush=True)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    mode = MODES[args.mode]
    real = w8_gemm.gemm_plan
    g = torch.Generator(device="cuda").manual_seed(5)
    res = dict(card=card, mode=args.mode, warm=args.warm, rows=[])
    for name, K, N, count, Ms, call, plain, make_x in _products(mode, args, g):
        for M in Ms:
            x = make_x(M)
            chosen = real(M, K, N, count, sm, mode=mode)
            ref = plain(x).float()
            variants = [v for v, spec in enumerate(w8_gemm.VARIANTS[mode])
                        if (spec[0] == 1) == (chosen.mt == 1)]
            seen = set()
            for v in variants:
                for s in range(1, w8_gemm.MAX_CLUSTER + 1):
                    plan = real(M, K, N, count, sm, mode=mode, variant=v, splits=s)
                    if plan in seen:
                        continue
                    seen.add(plan)
                    w8_gemm.gemm_plan = functools.partial(real, variant=v, splits=s)
                    w8_gemm._PLANS.clear()
                    try:
                        out = call(x, 0).float()
                        err = float((out - ref).abs().max() / ref.abs().max())
                        n = 36 if K * N * count < 2e8 else 8
                        ms = time_ms(lambda i: call(x, i), n=n)
                    finally:
                        w8_gemm.gemm_plan = real
                        w8_gemm._PLANS.clear()
                    blocks = (plan.tiles * count + plan.tail_blocks) * plan.row_tiles
                    row = dict(shape=f"{name} M={M}", variant=v, bn=plan.bn, mt=plan.mt,
                               splits=plan.splits, blocks=blocks * plan.splits, ms=ms,
                               rel_err=err, chosen=plan == chosen)
                    res["rows"].append(row)
                    print(f"{name} M={M} variant {v} (MT {plan.mt}, BN {plan.bn}) splits "
                          f"{plan.splits}: {row['blocks']} blocks, {ms * 1e3:.2f} µs, max abs "
                          f"error {err:.1e} of the largest output"
                          f"{'  <- plan' if row['chosen'] else ''}", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
