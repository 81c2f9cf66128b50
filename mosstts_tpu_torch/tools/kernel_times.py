"""The kernels' device times of ``chip_smoke.py`` phase 3 for the
``mosstts_tpu_torch`` of any checkout, so that two commits can be compared
on one NVIDIA GPU.

    python3 mosstts_tpu_torch/tools/kernel_times.py --root DIR [--only attention|gemm|f32]

Run it as a file, as ``tools/bf16_path.py``: it imports ``chip_smoke`` and
the port from ``--root`` (a checkout, e.g. an archive of another commit
unpacked under the git-ignored ``build/``).

* attention: that tree's ``phase_kernels`` and ``phase_kernels_server``:
  each kernel against its plain version, then its device time per call from
  CUDA-graph replays.
* gemm: the tree's own ``w8a16_gemm(x, q, scale, out_dtype)`` (the same
  signature in every tree since it was written) at every ``GEMM_8B`` shape
  of its ``chip_smoke.py``, at M = 1 and 16 and, for the backbone weights,
  96 and 640: (K, N) int8 layers of a 36-layer stack, call i reading layer
  i % 36 (cold in L2, as a decode step finds them), the text head, and the
  32-head audio stack in the layout the tree's ``QuantWeight`` keeps it;
  and the tree's ``w8a8_gemm`` and ``int4_gemm`` at their tools' shapes
  (``tools/tune_mm8.py``, ``tools/probe_int4.py``), timed first, before
  the W8A16 shapes' allocations can differ between the trees, with int4's
  yardstick ``torch._weight_int4pack_mm`` (``int4_library``) beside it.
  Inputs from one seed, the same in every tree.
* f32: the tree's ``w8f32_gemm(x, q, scale)`` (float32 x) at its
  ``chip_smoke.codec_f32_shapes()`` (``codec_1p6b()``'s encoder products)
  and M = 200, 100 (the encoder's 100-frame chunks of one and two waves),
  50, 12 and 1, warm (one weight every call, as smoke phase 13a
  times it) and cold (22 layers, the encoder's, read in turn).

One JSON line last: µs per call by kernel and shape, and a digest of each
W8A16 shape's output bits (layer 0). Compare two trees only within one
call, in the order A B B A.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

L8 = 36  # 8B layers: a backbone weight's stack


def int4_library(x, packed):
    """``torch._weight_int4pack_mm`` (tinygemm) on the int4 product of
    ``x`` (M, D) bf16 and each packed layer of ``packed`` (L, D/2, N), the
    yardstick of ``int4_gemm``: (call i -> layer i % L, a note), or (None,
    the reason) where this PyTorch build refuses the op. Its weights are
    the signed nibbles (``unpack_int4``: rows D/2 of lo over hi) as uint4
    ``s + 8``, (N, D/2) bytes with even k in the high nibble, packed by
    ``torch._convert_weight_to_int4pack`` outside the timing; groups of 128
    with scale 1 and zero 0 (tinygemm takes ``(q - 8) * scale + zero``), so
    it computes the same function, rounded to bf16. Its layer 0 is held
    against ``int4_gemm_ref`` first (as a bf16 result of f32 sums); a wrong
    result raises."""
    import torch
    from mosstts_tpu_torch.ops.kernels import w8_gemm

    L, h, N = packed.shape
    try:
        layers = []
        for p in packed:
            lo, hi = w8_gemm.unpack_int4(p)
            u = (torch.cat([lo, hi]).to(torch.int32) + 8).t()  # (N, D) in 0..15
            w = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous()
            layers.append(torch._convert_weight_to_int4pack(w, 8))
        sz = torch.zeros((2 * h // 128, N, 2), dtype=torch.bfloat16, device=x.device)
        sz[..., 0] = 1
        fn = (lambda i: torch._weight_int4pack_mm(x, layers[i % L], 128, sz))
        got = fn(0).float()
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0]}"
    ref = w8_gemm.int4_gemm_ref(x, packed[0])
    lo, hi = w8_gemm.unpack_int4(packed[0])
    xa = x.float().abs()
    absref = xa[:, :h] @ lo.float().abs() + xa[:, h:] @ hi.float().abs()
    err = (got - ref).abs()
    if not bool((err <= 2.0 ** -7 * ref.abs() + 1e-4 * absref + 1e-6).all()):
        raise AssertionError(f"torch._weight_int4pack_mm disagrees with int4_gemm_ref: max abs "
                             f"err {float(err.max())}")
    return fn, f"agrees with int4_gemm_ref (max abs err {float(err.max()):.3e}, bf16 output)"


def gemm_times(torch) -> dict:
    """µs per call of the imported tree's W8A16 at every 8B shape, and of
    its W8A8 and int4 at their tools' shapes."""
    import chip_smoke
    from mosstts_tpu_torch.ops import quant
    from mosstts_tpu_torch.ops.kernels import w8_gemm
    from mosstts_tpu_torch.tools import probe_int4, tune_mm8
    from mosstts_tpu_torch.tools.kernel_inputs import time_ms

    dev, res = "cuda", {}
    # the tools' GEMMs first, while both trees' processes have allocated the same
    x, w8, scale = tune_mm8.make_inputs(128, 16, 4096, 12288)
    res["w8a8 B=128"] = round(time_ms(lambda i: w8_gemm.w8a8_gemm(x, w8[i % 16],
                                                                   scale[i % 16])) * 1e3, 2)
    del x, w8, scale
    x, _, packed = probe_int4.make_inputs()
    res["int4 B=64"] = round(time_ms(lambda i: w8_gemm.int4_gemm(x, packed[i % 16])) * 1e3, 2)
    lib, note = int4_library(x, packed)
    print(f"int4 B=64 torch._weight_int4pack_mm: {note}", flush=True)
    res["int4 B=64 torch._weight_int4pack_mm"] = (round(time_ms(lib) * 1e3, 2) if lib is not None
                                                  else None)
    del x, packed, lib
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(5)
    for name, K, N, count, out_dtype in chip_smoke.GEMM_8B:
        L = 1 if count or name.endswith("head") else L8
        shape = ((count,) if count else (L,)) + (K, N)
        q = torch.empty(shape, dtype=torch.int8, device=dev).random_(-127, 128, generator=g)
        sc = torch.rand(shape[:-2] + (N,), generator=g, device=dev) * 0.019 + 0.001
        if count:  # the serving layout of the stack
            w = quant.QuantWeight(q, sc)
            pick = (lambda i, w=w: (w.q, w.scale))
        else:
            pick = (lambda i, q=q, sc=sc, L=L: (q[i % L], sc[i % L]))
        for M in (1, 16) + ((96, 640) if L > 1 else ()):
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            n = 36 if K * N * (count or 1) < 2e8 else 8
            ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, *pick(i), out_dtype), n=n)
            res[f"w8a16 {name} M={M}"] = round(ms * 1e3, 2)
            # the output's bits (layer 0), to hold two trees' kernels bit for bit
            out = w8_gemm.w8a16_gemm(x, *pick(0), out_dtype)
            res[f"w8a16 {name} M={M} bits"] = hashlib.sha256(
                out.view(torch.int16 if out.dtype == torch.bfloat16 else torch.int32)
                .cpu().numpy().tobytes()).hexdigest()[:16]
            print(f"w8a16 {name} M={M}: {ms * 1e3:.2f} µs", flush=True)
        del q, sc, pick
        torch.cuda.empty_cache()
    return res


def f32_times(torch) -> dict:
    """µs per call of the imported tree's ``w8f32_gemm`` at the codec's
    shapes, warm and cold in L2."""
    import chip_smoke
    from mosstts_tpu_torch.ops.kernels import w8_gemm
    from mosstts_tpu_torch.tools.kernel_inputs import time_ms

    dev, res, L = "cuda", {}, 22
    g = torch.Generator(device=dev).manual_seed(14)
    for name, K, N in chip_smoke.codec_f32_shapes():
        q = torch.empty((L, K, N), dtype=torch.int8, device=dev).random_(-127, 128, generator=g)
        sc = torch.rand((L, N), generator=g, device=dev) * 0.019 + 0.001
        for M in (200, 100, 50, 12, 1):
            x = torch.randn((M, K), generator=g, device=dev)
            for label, pick in (("warm", lambda i: 0), ("cold", lambda i: i % L)):
                ms = time_ms(lambda i: w8_gemm.w8f32_gemm(x, q[pick(i)], sc[pick(i)]))
                res[f"w8f32 {name} M={M} {label}"] = round(ms * 1e3, 2)
                print(f"w8f32 {name} M={M} {label}: {ms * 1e3:.2f} µs", flush=True)
        del q, sc
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, required=True, help="the checkout to measure")
    ap.add_argument("--only", choices=("attention", "gemm", "f32"), default=None,
                    help="time only these kernels (default: attention and gemm)")
    args = ap.parse_args(argv)
    root = args.root.resolve()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    os.chdir(root)  # the tree builds its kernels under its own build/
    sys.path.insert(0, str(root))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"root": str(root), "card": chip_smoke.card_line()}
    if args.only == "f32":
        res.update(f32_times(torch))
    if args.only is None or args.only == "attention":
        numbers = chip_smoke.phase_kernels()
        numbers.update(chip_smoke.phase_kernels_server())
        for name, n in numbers.items():
            if isinstance(n, dict) and "ms" in n:
                res[name] = round(n["ms"] * 1e3, 2)
                for sh in n.get("shapes", ()):
                    res[f"{name} {sh['shape']}"] = round(sh["ms"] * 1e3, 2)
    if args.only is None or args.only == "gemm":
        res.update(gemm_times(torch))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
