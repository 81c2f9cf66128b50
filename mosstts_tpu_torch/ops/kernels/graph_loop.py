"""Device-resident loops: the control kernels of ``csrc/graph_loop.cu``,
their plain PyTorch versions, and the builders of the conditional-node CUDA
graphs that run a loop on the card (``engine/step_graph.DeviceLoop``).

The JAX package runs its decode loops as single device programs: a
``lax.while_loop`` whose condition is read on the device after every step
(``mosstts_tpu/models/delay.py`` ``delay_generate_on_device`` and
``delay_decode_until_event``, the servers' ``_event_fn``, ``_drain_fn``)
or a ``fori_loop`` of k steps (``_block_fn``). Here a loop is one parent
CUDA graph: an init-condition kernel, then a conditional WHILE node whose
body holds the captured step graph as a child-graph node and a condition
kernel that sets the node's handle after the step. The drain adds an
admission kernel, one IF node per prompt bucket (gather the staged prompt
row, replay the bucket's prefill graph, splice the row into the slot) and a
collect kernel.

Replaces no Pallas kernel. Each kernel has its plain version here (the CPU
runs the loops eagerly and evaluates the same condition after every step,
which is JAX's ``while_loop`` exactly), and a launch count: a standalone
launch adds one where the wrapper launches it; a loop adds its kernel
nodes' runs, read back after the launch (``DeviceLoop``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build

LAUNCHES_COND = 0  # loop-condition kernel runs since the count was last set to 0
LAUNCHES_ADMIT = 0  # drain admission kernel runs
LAUNCHES_COLLECT = 0  # drain collect kernel runs
LAUNCHES_COPY = 0  # row-copy kernel runs (drain gather and splice)
LAUNCHES_FEED = 0  # fed-column kernel runs (the Realtime text feed)

GENERATE, EVENT, BLOCK, DRAIN = 0, 1, 2, 3
# the int32 control words of a loop (csrc/graph_loop.cu)
I, LIMIT, COND, QI, QN, SLOT, ADM_QI = 0, 1, 2, 3, 4, 5, 6
CTRL_WORDS = 8
MAX_SAMP = 8
MAX_BUCKETS = 64

_p = ctypes.c_void_p
_i = ctypes.c_int


class CondArgs(ctypes.Structure):
    _fields_ = [("kind", _i), ("B", _i), ("flags", _p), ("n_flags", _i), ("invert", _i),
                ("step", _p), ("n_step", _i), ("ctrl", _p), ("watch", _p), ("budget", _p),
                ("active", _p), ("pos", _p), ("attend", _i)]


class DrainArgs(ctypes.Structure):
    _fields_ = [("ctrl", _p), ("slots", _i), ("n_buckets", _i), ("active", _p),
                ("slot_rid", _p), ("budget", _p), ("qbucket", _p), ("qbudget", _p),
                ("qkeys", _p), ("small_rng", _p), ("handles", _p), ("n_f32", _i), ("n_u8", _i),
                ("f_dst", _p * MAX_SAMP), ("f_src", _p * MAX_SAMP), ("f_pre", _p * MAX_SAMP),
                ("u_dst", _p * MAX_SAMP), ("u_src", _p * MAX_SAMP), ("u_pre", _p * MAX_SAMP),
                ("is_stopping", _p), ("step", _p), ("out", _p), ("results", _p),
                ("rsteps", _p), ("out_row", ctypes.c_int64)]


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


def _fn(name: str, argtypes):
    return _build.kernel(name, argtypes)


# ---- the plain versions ------------------------------------------------------
def loop_cond_plain(kind: int, i: int, limit: int, *, flags=None, invert: bool = False,
                    step=None, watch=None, budget=None, active=None, pos=None, attend: int = 0,
                    qi: int = 0, qn: int = 0) -> bool:
    """The loop condition after ``i`` steps (``csrc/graph_loop.cu``'s
    ``loop_cond_kernel``): GENERATE ``min(step) < limit & ~all(stopped)``;
    EVENT ``i < limit & ~any(watch & (stopped | i >= budget))``; BLOCK
    ``i < limit``; DRAIN ``(qi < qn | any(active)) & ~any(active & pos >=
    attend) & i < limit``. ``stopped`` is ``flags``, or ``~flags`` with
    ``invert`` (flags that say "unfinished")."""
    if kind == BLOCK:
        return i < limit
    if kind == DRAIN:
        act = active.bool()
        work = qi < qn or bool(act.any())
        return work and not bool((act & (pos >= attend)).any()) and i < limit
    stopped = ~flags.bool() if invert else flags.bool()
    if kind == GENERATE:
        return bool((step < limit).any()) and not bool(stopped.all())
    event = watch.bool() & (stopped | (i >= budget))
    return i < limit and not bool(event.any())


def drain_admit_plain(ctrl: np.ndarray, active: torch.Tensor, slot_rid: torch.Tensor,
                      budget: torch.Tensor, qbucket: np.ndarray, qbudget: torch.Tensor,
                      qkeys: torch.Tensor, small_rng: torch.Tensor,
                      samp: Sequence[tuple]) -> int:
    """The drain's admission (``drain_admit_kernel``): when a slot is free
    and requests remain, the first free slot takes request ``ctrl[QI]``:
    its budget, its sampling row (``samp``: (slot tensor, staged rows,
    admission 0-dim tensor) triples) and its key into the admission state,
    ``active``, ``slot_rid``, and ``ctrl`` advances (SLOT, ADM_QI, QI).
    Returns the request's prompt-bucket index, or -1 (no admission)."""
    free = (~active.bool()).nonzero()
    qi = int(ctrl[QI])
    if len(free) == 0 or qi >= ctrl[QN]:
        return -1
    slot = int(free[0, 0])
    ctrl[SLOT], ctrl[ADM_QI], ctrl[QI] = slot, qi, qi + 1
    active[slot] = True
    slot_rid[slot] = qi
    budget[slot] = qbudget[qi]
    for dst, src, pre in samp:
        dst[slot] = src[qi]
        pre.copy_(src[qi])
    small_rng[0] = qkeys[qi]
    return int(qbucket[qi])


def drain_collect_plain(active: torch.Tensor, is_stopping: torch.Tensor, step: torch.Tensor,
                        budget: torch.Tensor, slot_rid: torch.Tensor, out: torch.Tensor,
                        results: torch.Tensor, rsteps: torch.Tensor) -> None:
    """The drain's collect (``drain_collect_kernel``): each active slot that
    stopped or reached its budget writes its frames into its request's
    result row and ``min(step, budget)`` into ``rsteps``, and leaves
    ``active``."""
    stopped = active.bool() & (is_stopping.bool() | (step >= budget))
    for s in stopped.nonzero()[:, 0].tolist():
        rid = int(slot_rid[s])
        results[rid] = out[s]
        rsteps[rid] = torch.minimum(step[s], budget[s])
        active[s] = False


# ---- the kernels, launched alone (the plain-vs-kernel checks) -----------------
def cond_args(kind: int, ctrl: torch.Tensor, *, flags=None, invert: bool = False, step=None,
              watch=None, budget=None, active=None, pos=None, attend: int = 0) -> CondArgs:
    """The condition kernel's arguments over device tensors: ``flags`` bool,
    ``step``/``watch``/``budget``/``pos`` int32, ``active`` bool,
    ``ctrl`` the int32 control words."""
    B = next(t.shape[0] for t in (watch, active, flags, step) if t is not None) \
        if kind != BLOCK else 0
    return CondArgs(kind=kind, B=B, flags=_ptr(flags),
                    n_flags=0 if flags is None else flags.numel(), invert=int(invert),
                    step=_ptr(step), n_step=0 if step is None else step.numel(), ctrl=_ptr(ctrl),
                    watch=_ptr(watch), budget=_ptr(budget), active=_ptr(active), pos=_ptr(pos),
                    attend=attend)


def loop_cond(args: CondArgs, advance: bool, device) -> None:
    """One run of the condition kernel (in a one-node graph, synchronised):
    ``ctrl[I] += advance``, ``ctrl[COND]`` = the condition."""
    fn = _fn("mosstts_loop_cond", [ctypes.POINTER(CondArgs), _i, _p])
    _check("mosstts_loop_cond", fn(ctypes.byref(args), int(advance), _stream(device)))
    global LAUNCHES_COND
    LAUNCHES_COND += 1


def drain_admit(args: DrainArgs, device) -> None:
    fn = _fn("mosstts_drain_admit", [ctypes.POINTER(DrainArgs), _p])
    _check("mosstts_drain_admit", fn(ctypes.byref(args), _stream(device)))
    global LAUNCHES_ADMIT
    LAUNCHES_ADMIT += 1


def drain_collect(args: DrainArgs, device) -> None:
    fn = _fn("mosstts_drain_collect", [ctypes.POINTER(DrainArgs), _p])
    _check("mosstts_drain_collect", fn(ctypes.byref(args), _stream(device)))
    global LAUNCHES_COLLECT
    LAUNCHES_COLLECT += 1


def feed(staged: torch.Tensor, dst: torch.Tensor, ctrl: torch.Tensor) -> None:
    """``dst[b] = staged[b, ctrl[I]]`` (int64)."""
    fn = _fn("mosstts_feed", [_p, ctypes.c_int64, _p, _i, _p, _p])
    _check("mosstts_feed", fn(staged.data_ptr(), staged.stride(0), dst.data_ptr(),
                              dst.shape[0], ctrl.data_ptr(), _stream(dst.device)))
    global LAUNCHES_FEED
    LAUNCHES_FEED += 1


# ---- copy segments --------------------------------------------------------------
def seg(dst: torch.Tensor, src: Optional[torch.Tensor], *, dst_word: int = -1,
        src_word: int = -1, dst_axis: int = 0, src_axis: int = 0) -> list:
    """One copy segment (``Seg``): ``dst`` at index ``ctrl[dst_word]`` of
    its axis ``dst_axis`` (index 0 with -1) takes ``src`` at its index
    alike, or zeros when ``src`` is None. The dimensions after the axis are
    contiguous; those before it (at most one) are the outer chunks."""
    def geom(t, axis):
        if not t[(0,) * axis].is_contiguous() if axis else not t[0].is_contiguous():
            raise ValueError("copy segment: the dimensions after the axis must be contiguous")
        outer = int(np.prod(t.shape[:axis], dtype=np.int64))
        inner = int(np.prod(t.shape[axis + 1:], dtype=np.int64)) * t.element_size()
        outer_stride = t.stride(axis - 1) * t.element_size() if axis > 0 else 0
        return t.data_ptr(), outer, inner, outer_stride, t.stride(axis) * t.element_size()

    d_ptr, d_outer, d_chunk, d_ostride, d_idx = geom(dst, dst_axis)
    if src is None:
        s_ptr, s_ostride, s_idx = 0, 0, 0
    else:
        s_ptr, s_outer, s_chunk, s_ostride, s_idx = geom(src, src_axis)
        if (s_outer, s_chunk) != (d_outer, d_chunk):
            raise ValueError(f"copy segment: {(s_outer, s_chunk)} into {(d_outer, d_chunk)}")
    return [d_ptr, s_ptr, d_outer, d_chunk, d_ostride, s_ostride, d_idx, s_idx,
            (dst_word & 0xFFFFFFFF) | ((src_word & 0xFFFFFFFF) << 32)]


def seg_table(segs: list, device) -> torch.Tensor:
    """The segments as the device array the row-copy kernel reads."""
    a = np.asarray(segs, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)


def copy_rows(table: torch.Tensor, ctrl: torch.Tensor, blocks: int = 8) -> None:
    fn = _fn("mosstts_copy_rows", [_p, _i, _p, _i, _p])
    _check("mosstts_copy_rows", fn(table.data_ptr(), table.shape[0], ctrl.data_ptr(), blocks,
                                   _stream(table.device)))
    global LAUNCHES_COPY
    LAUNCHES_COPY += 1


# ---- the loop graphs -------------------------------------------------------------
def build_loop(step_graph: int, args: CondArgs, feed_src: Optional[torch.Tensor] = None,
               feed_dst: Optional[torch.Tensor] = None) -> int:
    """Instantiate the loop graph over ``step_graph`` (a ``cudaGraph_t``,
    cloned into the body): init condition -> WHILE { [feed] -> step ->
    condition }. Returns the executable graph. A driver without conditional
    nodes, or a step graph a conditional body refuses, raises with CUDA's
    error."""
    exec_out = _p()
    fn = _fn("mosstts_loop_build", [_p, ctypes.POINTER(CondArgs), _p, ctypes.c_int64, _p,
                                    ctypes.POINTER(_p)])
    rc = fn(step_graph, ctypes.byref(args), _ptr(feed_src),
            0 if feed_src is None else feed_src.stride(0), _ptr(feed_dst), ctypes.byref(exec_out))
    _check("mosstts_loop_build (a conditional WHILE node over the step graph)", rc)
    return exec_out.value


def build_drain(step_graph: int, prefill_graphs: Sequence[int], cargs: CondArgs,
                dargs: DrainArgs, gathers: Sequence[torch.Tensor], splice: torch.Tensor,
                handles: torch.Tensor) -> int:
    """Instantiate the drain graph (see the module docstring): one IF node
    per prompt bucket j over ``prefill_graphs[j]``, its gather segments
    ``gathers[j]``, and the shared ``splice`` segments; ``handles`` (int64,
    one word a bucket, on the device) receives the IF nodes' handles, which
    the admission kernel sets."""
    nb = len(prefill_graphs)
    if nb > MAX_BUCKETS:
        raise ValueError(f"the drain graph takes at most {MAX_BUCKETS} prompt buckets, got {nb}")
    exec_out = _p()
    fn = _fn("mosstts_drain_build", [_p, _p, ctypes.POINTER(CondArgs), ctypes.POINTER(DrainArgs),
                                     _p, _p, _p, _i, _p, ctypes.POINTER(_p)])
    graphs = (_p * nb)(*prefill_graphs)
    gptrs = (_p * nb)(*[g.data_ptr() for g in gathers])
    ngs = (_i * nb)(*[g.shape[0] for g in gathers])
    rc = fn(step_graph, graphs, ctypes.byref(cargs), ctypes.byref(dargs), gptrs, ngs,
            splice.data_ptr(), splice.shape[0], handles.data_ptr(), ctypes.byref(exec_out))
    _check("mosstts_drain_build (conditional WHILE/IF nodes over the step and prefill "
           "graphs)", rc)
    return exec_out.value


def launch(exec_handle: int, device) -> None:
    fn = _fn("mosstts_graph_launch", [_p, _p])
    _check("cudaGraphLaunch of a loop graph", fn(exec_handle, _stream(device)))


def destroy(exec_handle: int) -> None:
    fn = _fn("mosstts_graph_exec_destroy", [_p])
    fn(exec_handle)


def release(execs: dict) -> None:
    """Destroy the executable graphs ``execs`` holds (an owner's
    ``__del__``); at interpreter shutdown the library may be gone already,
    and nothing is left to free."""
    for ex in execs.values():
        try:
            destroy(ex)
        except (OSError, AttributeError, TypeError, ImportError):
            pass
    execs.clear()
