"""The int8 weight-streaming GEMM walk of ``tools/tune_mm8.py``, on the card.

    python3 -m mosstts_tpu_torch.tools.tune_mm8 [--batch 128] [--layers 16]
        [--din 4096] [--dout 12288]

Ports ``tools/tune_mm8.py``: ``y = x @ W8[li] * scale[li]`` over ``L``
stacked int8 layers (L, D, O) with per-output f32 scales, x (B, D) bf16. Each
walk feeds layer li's first D outputs, through tanh and bf16, to layer li+1
and keeps every layer's first output column, so the layers cannot be
reordered or skipped. The walks:

* ``xla_ref``: the plain PyTorch version (``w8_gemm.w8a16_gemm_ref``), the
  counterpart of the JAX tool's XLA int8 dot;
* ``mm8``: the W8A16 kernel; ``mm8_omajor`` is the same function (the JAX
  tool's two Pallas tilings of it are one kernel here);
* ``mm8_w8a8``: the W8A8 kernel (per-row int8 activations, int32 sums).

The JAX tool sweeps TPU tile shapes; the port has one kernel per mode and
sweeps nothing. It first holds each kernel's first layer against its plain
version, then times each walk by CUDA-graph replay and prints the weight
stream in GB/s and each kernel walk's difference from ``xla_ref`` (not a
check at the default shapes: every layer's outputs are ~N(0, 47^2), so the
tanh chain multiplies a rounding difference by ~8 per layer), then one JSON
line. The walks run on CPU tensors too (through the plain versions),
which is how the tests hold them against the JAX tool.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops.kernels import w8_gemm
from .kernel_inputs import card_line, time_ms


def _walk(x: torch.Tensor, layers: int, mm) -> torch.Tensor:
    h = x
    outs = []
    for li in range(layers):
        y = mm(h, li)  # (B, O) f32, scales applied
        outs.append(y[:, :1])
        h = torch.tanh(y[:, : x.shape[1]]).to(torch.bfloat16)
    return torch.cat(outs, dim=1)


def xla_ref(x, w8, scale):
    return _walk(x, w8.shape[0],
                 lambda h, li: w8_gemm.w8a16_gemm_ref(h, w8[li], scale[li], torch.float32))


def mm8(x, w8, scale):
    return _walk(x, w8.shape[0],
                 lambda h, li: w8_gemm.w8a16_gemm(h, w8[li], scale[li], torch.float32))


mm8_omajor = mm8


def mm8_w8a8(x, w8, scale):
    return _walk(x, w8.shape[0], lambda h, li: w8_gemm.w8a8_gemm(h, w8[li], scale[li]))


def make_inputs(batch: int, layers: int, din: int, dout: int, seed: int = 0):
    """The JAX tool's inputs, drawn on the card: int8 weights uniform in
    [-127, 127], scales uniform in [0.001, 0.02], x standard normal bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w8 = torch.empty((layers, din, dout), dtype=torch.int8, device="cuda")
    w8.random_(-127, 128, generator=g)
    scale = torch.rand((layers, dout), generator=g, device="cuda") * 0.019 + 0.001
    x = torch.randn((batch, din), generator=g, device="cuda").to(torch.bfloat16)
    return x, w8, scale


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--din", type=int, default=4096)
    ap.add_argument("--dout", type=int, default=12288)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    card = card_line()
    print(card, flush=True)
    x, w8, scale = make_inputs(args.batch, args.layers, args.din, args.dout)
    gb = args.layers * args.din * args.dout / 1e9
    res = dict(card=card, batch=args.batch, layers=args.layers, din=args.din, dout=args.dout)
    for name, kernel, plain in (("mm8", w8_gemm.w8a16_gemm, w8_gemm.w8a16_gemm_ref),
                                ("mm8_w8a8", w8_gemm.w8a8_gemm, w8_gemm.w8a8_gemm_ref)):
        call = (x, w8[0], scale[0]) + ((torch.float32,) if name == "mm8" else ())
        err = rel_err(kernel(*call), plain(*call))
        print(f"{name} layer 0 kernel vs plain: max rel err {err:.2e}", flush=True)
        if not err < 1e-5:  # f32 sums of exact products, in another order
            raise AssertionError(f"{name}: the kernel disagrees with its plain version: {err}")
        res[f"{name}_layer0_rel_err"] = err
    want = xla_ref(x, w8, scale)
    for name, fn in (("xla_ref", xla_ref), ("mm8", mm8), ("mm8_w8a8", mm8_w8a8)):
        ms = time_ms(lambda i: fn(x, w8, scale), n=3, reps=5)
        res[f"{name}_ms"] = ms
        line = f"{name}: {ms:.3f} ms ({gb / ms * 1e3:.0f} GB/s)"
        if name != "xla_ref":
            res[f"{name}_rel_err"] = rel_err(fn(x, w8, scale), want)
            line += f", walk's max rel difference from xla_ref {res[f'{name}_rel_err']:.2e}"
        print(line, flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
