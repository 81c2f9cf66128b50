"""The kernel wrappers' launch counts, read and advanced together.

Each wrapper adds one to its module's count where its code launches the
kernel. Under CUDA-graph capture that code runs once per graph, not once per
replay, so ``engine/step_graph.py`` records what a capture added
(``since``), takes it back (``restore``) and adds it again at every replay
(``add_replay``), to the wrapper's count and to ``IN_GRAPHS``. The counts
then say how many times each kernel ran on the device, and ``IN_GRAPHS`` how
many of those runs were inside replayed graphs. They are exact while one
thread at a time launches the counted kernels (a server's decode thread, a
solo engine): a capture takes back whatever the counts gained meanwhile,
another thread's launches included. ``COLLECTIVES`` counts, beside the
kernels and in the same way, the collectives of a sharded model's forward
(``ops/collectives.py``), which a graph captures and replays as it does
the kernels.
"""
from __future__ import annotations

from .. import collectives
from . import decode_attn, flash, graph_loop, paged_attn, threefry, w8_gemm

COUNTERS = {  # name -> (module, attribute) of a wrapper's launch count
    "flash": (flash, "LAUNCHES"),
    "decode": (decode_attn, "LAUNCHES"),
    "decode_q8": (decode_attn, "LAUNCHES_Q8"),
    "decode_q8t": (decode_attn, "LAUNCHES_Q8T"),
    "paged": (paged_attn, "LAUNCHES"),
    "paged_q8": (paged_attn, "LAUNCHES_Q8"),
    "w8a16": (w8_gemm, "LAUNCHES_W8A16"),
    "w8a16_bytes": (w8_gemm, "LAUNCHES_W8A16_BYTES"),
    "w8a8": (w8_gemm, "LAUNCHES_W8A8"),
    "int4": (w8_gemm, "LAUNCHES_INT4"),
    "w8f32": (w8_gemm, "LAUNCHES_W8F32"),
    "threefry_split": (threefry, "LAUNCHES_SPLIT"),
    "categorical": (threefry, "LAUNCHES_CATEGORICAL"),
    "loop_cond": (graph_loop, "LAUNCHES_COND"),
    "drain_admit": (graph_loop, "LAUNCHES_ADMIT"),
    "drain_collect": (graph_loop, "LAUNCHES_COLLECT"),
    "row_copy": (graph_loop, "LAUNCHES_COPY"),
    "feed": (graph_loop, "LAUNCHES_FEED"),
    "lazy_cond": (graph_loop, "LAUNCHES_LAZY"),
}
COLLECTIVES = {"nccl": (collectives, "LAUNCHES")}  # not kernels: counted alike
_ALL = {**COUNTERS, **COLLECTIVES}
IN_GRAPHS = dict.fromkeys(_ALL, 0)  # launches inside replayed CUDA graphs


def read() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _ALL.items()}


def reset() -> None:
    """Set every count and ``IN_GRAPHS`` to 0."""
    for name, (mod, attr) in _ALL.items():
        setattr(mod, attr, 0)
        IN_GRAPHS[name] = 0


def since(before: dict) -> dict:
    """The counts that grew since ``before`` (a ``read()``), by how much."""
    return {k: v - before[k] for k, v in read().items() if v != before[k]}


def restore(before: dict) -> None:
    for name, (mod, attr) in _ALL.items():
        setattr(mod, attr, before[name])


def add_replay(captured: dict, times: int = 1) -> None:
    """``times`` replays of a graph whose capture launched ``captured`` (a
    ``since()``): a loop graph runs its step graph once per step."""
    for name, n in captured.items():
        mod, attr = _ALL[name]
        setattr(mod, attr, getattr(mod, attr) + n * times)
        IN_GRAPHS[name] += n * times
