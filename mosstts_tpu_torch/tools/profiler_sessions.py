"""Does each ``torch.profiler`` session see every device kernel launched in
it? On one NVIDIA GPU, from the root of a checkout.

    python3 -m mosstts_tpu_torch.tools.profiler_sessions [--sessions 8]

Runs one child process per case, one after another. Each child first does
its case's work, then opens ``--sessions`` sessions of each kind, one
after another, recording host and device activity. A session launches
seven marked kernels, ``neg``, W8A16 (M=16, 4096 x 4096,
``csrc/w8_gemm.cu``), ``exp``, W8A16, ``sigmoid``, W8A16, ``sqrt``
(``nwewgws``), synchronizes and closes. The child records the marked
kernels the session saw, in device order, how many of a kind's throwaway
kernels it saw, the process's age, and the last kernel's device start
less the host's start of the last launch (``lag``; a few microseconds
when both clocks agree). The kinds: ``plain``; ``burst16``/``burst64``,
16 or 64 throwaway ``spin_kernel`` launches (``torch.cuda._sleep(0)``)
first, as ``profile_step.device_profile`` opens a session with 64. The
cases: ``none``, no work first; ``card_tests``, the card tests of
``tests/test_torch_graphs_cuda.py`` and ``tests/test_torch_kernels_cuda.py``
first, in the child's own process (``pytest.main``; its exit code is
recorded).

Prints the card's ``nvidia-smi`` line, each case's sessions
(``burst seen + marked seen @ age : lag``), and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .kernel_inputs import card_line

CASES = ("none", "card_tests")
KINDS = ("plain", "burst16", "burst64")  # burstN: N throwaway spin kernels open the window
# the kernels a session launches, in order, and the letters that name them
ORDER = "nwewgws"
NAMES = (("n", "neg_kernel"), ("w", "ring_kernel"), ("e", "exp_kernel"),
         ("g", "sigmoid_kernel"), ("s", "sqrt_kernel"))


def _child(case: str, sessions: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..ops.kernels import w8_gemm
    from ..ops.quant import quantize_weight

    t0 = time.perf_counter()
    res = {}
    if case == "card_tests":
        import pytest

        res["pytest_rc"] = int(pytest.main([
            "--noconftest", "-q", "-p", "no:cacheprovider", "tests/test_torch_graphs_cuda.py",
            "tests/test_torch_kernels_cuda.py"]))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((16, 4096), generator=g, device="cuda").bfloat16()
    w = quantize_weight(torch.randn((4096, 4096), generator=g, device="cuda"))
    ops = dict(n=x.neg, e=x.exp, g=x.sigmoid, s=x.abs().sqrt,
               w=lambda: w8_gemm.w8a16_gemm(x, w.q, w.scale))
    for c in ORDER:
        ops[c]()
    torch.cuda.synchronize()
    for kind in KINDS:
        res[kind] = []
        for _ in range(sessions):
            age = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(int(kind[5:] or 0)):
                    torch.cuda._sleep(0)
                for c in ORDER:
                    ops[c]()
                torch.cuda.synchronize()
            evts = prof.events()
            gpu = sorted((e for e in evts if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
            cpu = sorted((e for e in evts if e.name.startswith("cudaLaunchKernel")),
                         key=lambda e: e.time_range.start)
            burst = sum("spin_kernel" in e.name for e in gpu)
            gpu = [e for e in gpu if "spin_kernel" not in e.name]
            seen = "".join(next((c for c, k in NAMES if k in e.name), "?") for e in gpu)
            # the last kernel against its launch on the host (both clocks in the trace's us)
            lag = gpu[-1].time_range.start - cpu[-1].time_range.start if gpu and cpu else None
            res[kind].append(f"{burst}+{seen}@{age:.0f}s:lag{lag:.0f}us" if lag is not None
                             else f"{burst}+{seen}@{age:.0f}s")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--child", choices=CASES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool profiles a GPU")
    if args.child:
        print(json.dumps(_child(args.child, args.sessions)))
        return
    card = card_line()
    print(card, flush=True)
    res = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    for case in CASES:
        out = subprocess.run([sys.executable, "-m", __spec__.name, "--child", case,
                              "--sessions", str(args.sessions)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"case {case} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        res[case] = json.loads(out.stdout.strip().splitlines()[-1])
        for kind, got in res[case].items():
            print(f"{case}, {kind}: {got if isinstance(got, int) else ' '.join(got)}",
                  flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
