"""bf16 ``dense`` at the 8B decode and prefill shapes against cuBLAS's
reduced-precision reduction flag, on one NVIDIA GPU.

    python3 -m mosstts_tpu_torch.tools.bf16_dense [--M 1 16 96 640 3200]

PyTorch lets cuBLAS reduce a bf16 product's split-K partial sums in bf16
unless ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
is False; its default is True. For each product of ``delay_8b()``
(``wq``, ``wk``, ``w_gate``, ``w_down``, the text head; x (M, K) and random
bf16 weights) at the decode rows M = 1 and 16 and the prefill rows 96, 640
and 3200 (16 prompts of 200 tokens; the text head only where M <= 16, as
the model reads only the last position) this prints, against the float32
product ``ref`` (TF32 off):

- the port's ``ops.basic.dense`` (``torch.matmul``) with the flag True
  (the default) and False: the elements that differ between the two, and
  for each the elements that are not ``ref`` rounded once to bf16
  (``off``: another summation order may round a value one ulp the other
  way);
- device time per call with each, from CUDA-graph replays over 4 weights
  (``kernel_inputs.time_ms``).

The card's ``nvidia-smi`` line comes first and one JSON object last.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..core.config import delay_8b
from ..ops.basic import dense
from .kernel_inputs import card_line, time_ms

ROT = 4  # weights per shape, rotated through by the timed calls


def measure(M: int, name: str, K: int, N: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(K * 7 + N + M)
    x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
    ws = [(torch.randn((K, N), generator=g, device="cuda") * 0.02).bfloat16() for _ in range(ROT)]
    ref = x.float() @ ws[0].float()
    flags = torch.backends.cuda.matmul
    res = dict(name=name, M=M, K=K, N=N)
    outs = {}
    try:
        for allow in (True, False):
            flags.allow_bf16_reduced_precision_reduction = allow
            tag = "default" if allow else "strict"
            outs[tag] = dense(x, ws[0])
            res[f"{tag}_ms"] = time_ms(lambda i: dense(x, ws[i % ROT]))
    finally:
        flags.allow_bf16_reduced_precision_reduction = True
    once = ref.bfloat16()
    for tag, out in outs.items():
        res[f"{tag}_off"] = int((out != once).sum())
    res["flag_differs"] = int((outs["default"] != outs["strict"]).sum())
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--M", type=int, nargs="+", default=[1, 16, 96, 640, 3200])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool measures a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    lc = delay_8b().language_config
    D, I, V = lc.hidden_size, lc.intermediate_size, lc.vocab_size
    shapes = (("wq", D, lc.num_attention_heads * lc.head_dim),
              ("wk", D, lc.num_key_value_heads * lc.head_dim),
              ("w_gate", D, I), ("w_down", I, D), ("text_head", D, V))
    rows = []
    for M in args.M:
        for name, K, N in shapes:
            if name == "text_head" and M > 16:
                continue
            r = measure(M, name, K, N)
            rows.append(r)
            print(f"M={M} {name} ({K}x{N}): dense flag True vs False differ at "
                  f"{r['flag_differs']} of {M * N}, off {r['default_off']} / "
                  f"{r['strict_off']}, {r['default_ms']:.4f} / {r['strict_ms']:.4f} ms",
                  flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, rows=rows)))


if __name__ == "__main__":
    main()
