"""JAX's threefry2x32 on the card: the CUDA kernels of ``csrc/threefry.cu``
(a row-wise key split and a fused Gumbel-max categorical) and their plain
PyTorch versions in ``ops/sampling.py``.

Replaces no Pallas kernel: the JAX package splits the keys held in its
decode state and draws with ``jax.random.categorical`` inside its compiled
step. These kernels let the port keep keys in its state too, so a CUDA
graph that the card repeats inside one launch draws fresh noise each time
(``engine/step_graph.DeviceLoop``).

Each wrapper runs the plain version for CPU tensors and its kernel for CUDA
tensors, never falling back from one to the other, raises on what the
kernel does not take, and counts its launches.
"""
from __future__ import annotations

import torch

from . import _build
from .. import sampling
from .decode_attn import _on_cuda

LAUNCHES_SPLIT = 0  # split kernel launches since the count was last set to 0
LAUNCHES_CATEGORICAL = 0  # fused categorical kernel launches


def _check_keys(name: str, keys: torch.Tensor, rows: int, device) -> None:
    if (keys.dtype != torch.int64 or keys.ndim != 2 or keys.shape != (rows, 2)
            or keys.stride(1) != 1 or keys.device != device):
        raise ValueError(f"{name}: keys must be int64 (B, 2) with contiguous words on the "
                         f"logits' device, got {tuple(keys.shape)} {keys.dtype}")


def split(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Split each key of ``keys`` (B, 2) into ``n``: (B, n, 2) int64, JAX's
    ``random.split`` row by row."""
    if not _on_cuda("threefry.split", keys):
        return sampling.split(keys, n)
    _check_keys("threefry.split", keys, keys.shape[0], keys.device)
    import ctypes

    B = keys.shape[0]
    out = torch.empty((B, n, 2), dtype=torch.int64, device=keys.device)
    c = ctypes.c_void_p
    fn = _build.kernel("mosstts_threefry_split",
                       [c, ctypes.c_int64, c, ctypes.c_int, ctypes.c_int, c])
    rc = fn(keys.data_ptr(), keys.stride(0), out.data_ptr(), B, n,
            torch.cuda.current_stream(keys.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mosstts_threefry_split kernel launch failed: cudaError {rc}")
    global LAUNCHES_SPLIT
    LAUNCHES_SPLIT += 1
    return out


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """JAX's ``random.categorical`` of each row of ``logits`` (B, ..., V)
    with its own key ``keys[b]``: (B, ...) int64, the index of the largest
    ``logits + gumbel`` (``ops.sampling.categorical_plain``)."""
    if not _on_cuda("threefry.categorical", logits):
        return sampling.categorical_plain(keys, logits)
    B, V = logits.shape[0], logits.shape[-1]
    _check_keys("threefry.categorical", keys, B, logits.device)
    import ctypes

    x = logits.float().contiguous()
    M = x[0].numel() // V if B else 0
    out = torch.empty(logits.shape[:-1], dtype=torch.int64, device=logits.device)
    c = ctypes.c_void_p
    fn = _build.kernel("mosstts_threefry_categorical",
                       [c, ctypes.c_int64, c, c, ctypes.c_int, ctypes.c_int, ctypes.c_int, c])
    rc = fn(keys.data_ptr(), keys.stride(0), x.data_ptr(), out.data_ptr(), B, M, V,
            torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mosstts_threefry_categorical kernel launch failed: cudaError {rc}")
    global LAUNCHES_CATEGORICAL
    LAUNCHES_CATEGORICAL += 1
    return out
