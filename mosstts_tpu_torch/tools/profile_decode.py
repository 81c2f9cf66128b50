"""Where the time of the decode-attention kernels goes, on one NVIDIA GPU.

    python3 -m mosstts_tpu_torch.tools.profile_decode [--batch 4 16] [--attend 256 1024]

For each batch size and attend length, makes the inputs of
``tools/kernel_inputs.decode_inputs`` (the 8B backbone's cache shape, linear
and paged, bf16 and int8, the int8 cache with f32 and bf16 scales), then runs each kernel ``--calls`` times under
``torch.profiler`` (layer i % 36 on call i) and prints the device time per
call of each device kernel it ran (one: the clustered split-KV kernel,
``decode_kernel``) and the device kernels per call, beside the call's bound
from ``kernel_inputs.decode_bound``. The card's ``nvidia-smi`` line comes
first and one JSON object of the numbers last.
"""
from __future__ import annotations

import argparse
import json

import torch

from .kernel_inputs import HD, KV, L, card_line, decode_bound, decode_inputs


def profile_kernel(fn, args, attend: int, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    inputs = [args(i % L) for i in range(calls)]
    for a in inputs[:3]:
        fn(*a, scale=HD ** -0.5, attend_len=attend)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in inputs:
            fn(*a, scale=HD ** -0.5, attend_len=attend)
        torch.cuda.synchronize()
    passes, n_kernels = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = "decode_kernel" if "decode_kernel" in e.key else e.key[:40]
            passes[name] = passes.get(name, 0.0) + e.self_device_time_total / calls / 1e3
            n_kernels += e.count
    passes["kernels_per_call"] = n_kernels / calls
    return passes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--attend", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--calls", type=int, default=72)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool profiles a GPU")
    card = card_line()
    print(card, flush=True)
    res = dict(card=card, rows=[])
    for B in args.batch:
        q, valid, kernels = decode_inputs(B)
        for attend in args.attend:
            for name, (fn, _, make_args, row_bytes, extra) in kernels.items():
                passes = profile_kernel(fn, make_args, attend, args.calls)
                bd = decode_bound(q, valid, attend, KV, row_bytes, extra)
                row = dict(kernel=name, batch=B, attend=attend, **bd, **passes)
                res["rows"].append(row)
                print(f"{name} B={B} attend={attend}: " + ", ".join(
                    f"{k} {v:g}" if k == "kernels_per_call" else f"{k} {v * 1e3:.2f} us"
                    for k, v in passes.items())
                    + f"; bound {bd['bound_ms'] * 1e3:.2f} us ({bd['bound_by']})", flush=True)
        del q, valid, kernels
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
