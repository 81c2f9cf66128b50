"""The attention and decode kernels' device times of ``chip_smoke.py``
phase 3 for the ``mosstts_tpu_torch`` of any checkout, so that two commits
can be compared on one NVIDIA GPU.

    python3 mosstts_tpu_torch/tools/kernel_times.py --root DIR

Run it as a file, as ``tools/bf16_path.py``: it imports ``chip_smoke`` and
the port from ``--root`` (a checkout, e.g. an archive of another commit
unpacked under the git-ignored ``build/``) and runs that tree's
``phase_kernels`` and ``phase_kernels_server``: each kernel against its
plain version, then its device time per call from CUDA-graph replays. One
JSON line last: µs per call by kernel, and by shape where the tree reports
shapes. Compare two trees only within one call, in the order A B B A.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, required=True, help="the checkout to measure")
    root = ap.parse_args(argv).root.resolve()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    os.chdir(root)  # the tree builds its kernels under its own build/
    sys.path.insert(0, str(root))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    numbers = chip_smoke.phase_kernels()
    numbers.update(chip_smoke.phase_kernels_server())
    res = {"root": str(root), "card": chip_smoke.card_line()}
    for name, n in numbers.items():
        if isinstance(n, dict) and "ms" in n:
            res[name] = round(n["ms"] * 1e3, 2)
            for sh in n.get("shapes", ()):
                res[f"{name} {sh['shape']}"] = round(sh["ms"] * 1e3, 2)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
