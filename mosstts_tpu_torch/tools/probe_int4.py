"""The int8-against-int4 weight-only GEMV walk of ``tools/probe_int4.py``, on
the card.

    python3 -m mosstts_tpu_torch.tools.probe_int4

Ports ``tools/probe_int4.py``: 16 "layers" of an 8B-like MLP weight
(B=64, D=4096, O=12288), each walk summing ``x @ W[li]`` in f32:

* ``walk_plain8``: the plain PyTorch int8 product (the JAX probe's XLA dot);
* ``walk_p8``: the W8A16 kernel with unit scales (the probe's ``mm8_pallas``);
* ``walk_p4``: the int4 kernel over nibble-packed weights (D/2, O) per layer,
  low nibble W[d], high nibble W[d + D/2] (the probe's ``mm4_pallas``).

The question is the probe's: does unpacking the nibbles keep up with the
halved byte stream? Each walk is timed by CUDA-graph replay and printed with
its weight stream in GB/s, then one JSON line; each kernel walk is held
against its plain version first. The walks also run on CPU tensors (the
plain versions), at any shape.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops.kernels import w8_gemm
from .kernel_inputs import card_line, time_ms

B, D, O, NL = 64, 4096, 12288, 16  # 8B-ish MLP shape, 16 "layers"


def walk_plain8(x, w8):
    ones = torch.ones(w8.shape[-1], dtype=torch.float32, device=x.device)
    acc = torch.zeros((x.shape[0], w8.shape[-1]), dtype=torch.float32, device=x.device)
    for li in range(w8.shape[0]):
        acc = acc + w8_gemm.w8a16_gemm_ref(x, w8[li], ones, torch.float32)
    return acc


def walk_p8(x, w8):
    ones = torch.ones(w8.shape[-1], dtype=torch.float32, device=x.device)
    acc = torch.zeros((x.shape[0], w8.shape[-1]), dtype=torch.float32, device=x.device)
    for li in range(w8.shape[0]):
        acc = acc + w8_gemm.w8a16_gemm(x, w8[li], ones, torch.float32)
    return acc


def walk_p4(x, packed):
    acc = torch.zeros((x.shape[0], packed.shape[-1]), dtype=torch.float32, device=x.device)
    for li in range(packed.shape[0]):
        acc = acc + w8_gemm.int4_gemm(x, packed[li])
    return acc


def walk_plain4(x, packed):
    acc = torch.zeros((x.shape[0], packed.shape[-1]), dtype=torch.float32, device=x.device)
    for li in range(packed.shape[0]):
        acc = acc + w8_gemm.int4_gemm_ref(x, packed[li])
    return acc


def make_inputs(seed: int = 0):
    """The probe's inputs on the card: x standard normal bf16, int8 weights
    uniform in [-127, 126], packed bytes uniform in [-128, 126]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda").to(torch.bfloat16)
    w8 = torch.empty((NL, D, O), dtype=torch.int8, device="cuda").random_(-127, 127, generator=g)
    packed = torch.empty((NL, D // 2, O), dtype=torch.int8, device="cuda")
    packed.random_(-128, 127, generator=g)
    return x, w8, packed


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    card = card_line()
    print(card, flush=True)
    x, w8, packed = make_inputs()
    for name, got, want in (("int8", walk_p8(x, w8), walk_plain8(x, w8)),
                            ("int4", walk_p4(x, packed), walk_plain4(x, packed))):
        err = float((got - want).abs().max() / (want.abs().max() + 1e-9))
        print(f"{name} kernel walk vs plain: max rel err {err:.2e}", flush=True)
        if not err < 1e-5:  # both sum exact products in f32: order only
            raise AssertionError(f"{name} kernel walk disagrees with its plain version: {err}")
    r = dict(card=card)
    r["plain_int8_ms"] = time_ms(lambda i: walk_plain8(x, w8), n=2, reps=5)
    r["kernel_int8_ms"] = time_ms(lambda i: walk_p8(x, w8), n=2, reps=5)
    r["kernel_int4_ms"] = time_ms(lambda i: walk_p4(x, packed), n=2, reps=5)
    gb8 = NL * D * O / 1e9
    for k, gb in (("plain_int8_ms", gb8), ("kernel_int8_ms", gb8), ("kernel_int4_ms", gb8 / 2)):
        print(f"{k}: {r[k]:.3f} ms, {gb:.2f} GB -> {gb / (r[k] / 1e3):.0f} GB/s", flush=True)
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
