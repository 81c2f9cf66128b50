"""Device-resident loops and splices: the control kernels of
``csrc/graph_loop.cu``, their plain PyTorch versions, and the functions
that build the conditional-node CUDA graphs that run a loop on the card
(``engine/step_graph.DeviceLoop``).

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

The row copy (``RowCopy``) is every server admission's splice (JAX's
``_insert_fn``, ``_insert_paged_fn``, the page-table programs,
``_insert_local_row``, ``_splice_rt_rows``): a list of ``Part``s, each a row
of a destination at an index read from an int32 control word on the device,
so one captured program serves every slot; an index outside the
destination's axis is dropped (JAX's ``mode="drop"``). ``text_lazy``'s
``lax.cond`` becomes a condition kernel and two IF nodes added to a decode
step's capture (``capture_lazy``).

Replaces no Pallas kernel. Each kernel has its plain version here (the CPU
runs the loops eagerly and evaluates the same condition after every step,
which is JAX's ``while_loop`` exactly), and a launch count: a standalone
launch adds one where the wrapper launches it; a loop adds its kernel
nodes' runs, read back after the launch (``DeviceLoop``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build

LAUNCHES_COND = 0  # loop-condition kernel runs since the count was last set to 0
LAUNCHES_ADMIT = 0  # drain admission kernel runs
LAUNCHES_COLLECT = 0  # drain collect kernel runs
LAUNCHES_COPY = 0  # row-copy kernel runs (the admissions' splices, the drain's gather)
LAUNCHES_FEED = 0  # fed-column kernel runs (the Realtime text feed)
LAUNCHES_LAZY = 0  # text_lazy condition kernel runs

GENERATE, EVENT, BLOCK, DRAIN = 0, 1, 2, 3
# the int32 control words of a loop and of an admission (csrc/graph_loop.cu):
# the loop's counters; the admission's slot, the drained request, a Local
# admission's cursor, a page-table entry and its page; a paged admission's
# table row follows at TABLE_ROW
I, LIMIT, COND, QI, QN, SLOT, ADM_QI, POS0, ENTRY, PAGE = range(10)
CTRL_WORDS = 12
TABLE_ROW = CTRL_WORDS
MAX_SAMP = 8
MAX_BUCKETS = 64

_p = ctypes.c_void_p
_i = ctypes.c_int


class CondArgs(ctypes.Structure):
    _fields_ = [("kind", _i), ("B", _i), ("flags", _p), ("n_flags", _i), ("invert", _i),
                ("step", _p), ("n_step", _i), ("ctrl", _p), ("watch", _p), ("budget", _p),
                ("active", _p), ("pos", _p), ("attend", _i)]


class LazyArgs(ctypes.Structure):
    _fields_ = [("sampling_text", _p), ("is_audio", _p), ("B", _i), ("counts", _p)]


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


# ---- the row copy ------------------------------------------------------------
class Part(NamedTuple):
    """One row copy: ``dst`` at index ``ctrl[dst_word]`` of its axis
    ``dst_axis`` (index 0 with -1) takes ``src`` at its index alike
    (``ctrl[src_word]`` of ``src_axis``), or zeros when ``src`` is None;
    an index outside ``dst``'s axis drops the copy."""
    dst: torch.Tensor
    src: Optional[torch.Tensor]
    dst_word: int = -1
    src_word: int = -1
    dst_axis: int = 0
    src_axis: int = 0


def _levels(part: Part) -> tuple:
    """A part's row as the kernel walks it: ``chunk`` contiguous bytes, at
    most two levels of (count, dst stride, src stride) in bytes around
    them, outer first. Raises where the row needs more."""
    d = part.dst.select(part.dst_axis, 0)
    s = None if part.src is None else part.src.select(part.src_axis, 0)
    if s is not None and (s.shape != d.shape or s.dtype != d.dtype):
        raise ValueError(f"row copy: {s.dtype} {tuple(s.shape)} into {d.dtype} {tuple(d.shape)}")
    es = d.element_size()
    dims = [(n, ds * es, (ss if s is not None else ds) * es)
            for n, ds, ss in zip(d.shape, d.stride(), (s if s is not None else d).stride())
            if n != 1]
    chunk, levels = es, []
    for n, ds, ss in reversed(dims):
        if not levels and ds == chunk and ss == chunk:
            chunk *= n
        elif levels and (ds, ss) == (levels[-1][0] * levels[-1][1],
                                     levels[-1][0] * levels[-1][2]):
            m, mds, mss = levels[-1]
            levels[-1] = (m * n, mds, mss)
        else:
            levels.append((n, ds, ss))
    if len(levels) > 2:
        raise ValueError(f"row copy: {tuple(d.shape)} with strides {d.stride()} takes more "
                         "than two levels around its contiguous chunk")
    levels += [(1, 0, 0)] * (2 - len(levels))
    return chunk, levels[1], levels[0]


def seg_table(parts: Sequence[Part], device) -> torch.Tensor:
    """The parts as the device array of ``Seg`` the row-copy kernel reads
    (made outside any capture: the upload is a host copy)."""
    rows = []
    for p in parts:
        chunk, (n_o, d_o, s_o), (n_m, d_m, s_m) = _levels(p)
        d_idx = p.dst.stride(p.dst_axis) * p.dst.element_size()
        s_idx = 0 if p.src is None else p.src.stride(p.src_axis) * p.src.element_size()
        rows.append([p.dst.data_ptr(), 0 if p.src is None else p.src.data_ptr(), n_o, n_m, chunk,
                     d_o, s_o, d_m, s_m, d_idx, s_idx, p.dst.shape[p.dst_axis],
                     (p.dst_word & 0xFFFFFFFF) | ((p.src_word & 0xFFFFFFFF) << 32)])
    a = np.asarray(rows, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)


def copy_rows_plain(parts: Sequence[Part], ctrl: torch.Tensor) -> None:
    """The row copy (``copy_rows_kernel``) part by part, the indices read
    from ``ctrl``; the parts write disjoint rows, so their order does not
    matter."""
    words = ctrl.tolist()
    for p in parts:
        di = words[p.dst_word] if p.dst_word >= 0 else 0
        if not 0 <= di < p.dst.shape[p.dst_axis]:
            continue
        d = p.dst.select(p.dst_axis, di)
        if p.src is None:
            d.zero_()
        else:
            d.copy_(p.src.select(p.src_axis, words[p.src_word] if p.src_word >= 0 else 0))


def copy_rows(table: torch.Tensor, ctrl: torch.Tensor, blocks: int = 8) -> None:
    fn = _fn("mosstts_copy_rows", [_p, _i, _p, _i, _p])
    _check("mosstts_copy_rows", fn(table.data_ptr(), table.shape[0], ctrl.data_ptr(), blocks,
                                   _stream(table.device)))
    global LAUNCHES_COPY
    LAUNCHES_COPY += 1


class RowCopy:
    """A fixed list of parts over the control words ``ctrl`` (int32, on the
    parts' device): ``()`` runs them as one launch of the row-copy kernel
    (``blocks`` blocks a part) for CUDA tensors, a launch a capture records,
    and through the plain version for CPU tensors. The parts' tensors and
    ``ctrl`` must outlive it at their addresses."""

    def __init__(self, parts: Sequence[Part], ctrl: torch.Tensor, blocks: int = 264):
        self.parts = [p for p in parts if p.dst.numel()]
        self.ctrl, self.blocks = ctrl, blocks
        self.table = seg_table(self.parts, ctrl.device) if ctrl.is_cuda else None

    def __call__(self) -> None:
        if self.table is None:
            copy_rows_plain(self.parts, self.ctrl)
        else:
            copy_rows(self.table, self.ctrl, self.blocks)


def set_words(ctrl: torch.Tensor, first: int, values) -> None:
    """Write ``values`` into the control words from ``first`` on, behind the
    work the stream holds (a pinned upload on the card)."""
    v = torch.as_tensor(np.asarray(values, np.int32))
    if ctrl.is_cuda:
        ctrl[first:first + v.numel()].copy_(v.pin_memory(), non_blocking=True)
    else:
        ctrl[first:first + v.numel()] = v


# ---- text_lazy's condition ------------------------------------------------------
def lazy_cond_plain(sampling_text: torch.Tensor, is_audio: torch.Tensor) -> bool:
    """``any(sampling_text & ~is_audio)``: some row samples free text, so
    the full-vocab branch runs (``lazy_cond_kernel``)."""
    return bool((sampling_text & ~is_audio).any())


def lazy_counts(device) -> torch.Tensor:
    """The card's text_lazy counters of ``device`` (int32: full-branch runs,
    2-column runs, the last decision), made at the first eager lazy step
    (a capture cannot make them)."""
    dev = torch.device(device)
    dev = torch.device(dev.type, torch.cuda.current_device() if dev.index is None else dev.index)
    t = _LAZY_COUNTS.get(dev)
    if t is None:
        t = _LAZY_COUNTS[dev] = torch.zeros(3, dtype=torch.int32, device=dev)
    return t


_LAZY_COUNTS: dict = {}
_HELD: list = []  # branch graphs the capture under way reads


def _lazy_args(sampling_text, is_audio) -> LazyArgs:
    return LazyArgs(sampling_text=sampling_text.data_ptr(), is_audio=is_audio.data_ptr(),
                    B=sampling_text.shape[0], counts=lazy_counts(sampling_text.device).data_ptr())


def lazy_cond_launch(sampling_text: torch.Tensor, is_audio: torch.Tensor) -> None:
    """The condition kernel alone: it counts the branch it picks and
    records the decision in ``lazy_counts``."""
    fn = _fn("mosstts_lazy_cond", [ctypes.POINTER(LazyArgs), _p])
    args = _lazy_args(sampling_text, is_audio)
    _check("mosstts_lazy_cond", fn(ctypes.byref(args), _stream(sampling_text.device)))
    global LAUNCHES_LAZY
    LAUNCHES_LAZY += 1


def lazy_cond(sampling_text: torch.Tensor, is_audio: torch.Tensor) -> bool:
    """The condition kernel, then a read of its decision: the eager lazy
    step on the card."""
    lazy_cond_launch(sampling_text.contiguous(), is_audio.contiguous())
    return bool(lazy_counts(sampling_text.device)[2])


def capture_lazy(sampling_text: torch.Tensor, is_audio: torch.Tensor, full, cheap) -> None:
    """Inside a capture under way on the current stream: the condition
    kernel and IF(full) -> IF(2 columns) over the captured branch graphs
    ``full`` and ``cheap`` (``torch.cuda.CUDAGraph(keep_graph=True)``),
    which the capturing graph then reads; they are held until the
    capture's owner takes them (``take_held``)."""
    fn = _fn("mosstts_lazy_capture", [ctypes.POINTER(LazyArgs), _p, _p, _p])
    st, ia = sampling_text.contiguous(), is_audio.contiguous()
    _HELD.extend([st, ia, full, cheap])
    args = _lazy_args(st, ia)
    _check("mosstts_lazy_capture (a condition kernel and two IF nodes in the capture)",
           fn(ctypes.byref(args), full.raw_cuda_graph(), cheap.raw_cuda_graph(),
              _stream(st.device)))
    global LAUNCHES_LAZY
    LAUNCHES_LAZY += 1


def take_held() -> list:
    """The branch graphs (and their inputs) that captures made since the
    last call: the captured graph's owner keeps them as long as it."""
    held = list(_HELD)
    _HELD.clear()
    return held


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
                dargs: DrainArgs, gathers: Sequence[torch.Tensor], handles: torch.Tensor) -> int:
    """Instantiate the drain graph (see the module docstring): one IF node
    per prompt bucket j over its gather segments ``gathers[j]`` and
    ``prefill_graphs[j]`` (the bucket's admission: prefill and splice);
    ``handles`` (int64, one word a bucket, on the device) receives the IF
    nodes' handles, which the admission kernel sets."""
    nb = len(prefill_graphs)
    if nb > MAX_BUCKETS:
        raise ValueError(f"the drain graph takes at most {MAX_BUCKETS} prompt buckets, got {nb}")
    exec_out = _p()
    fn = _fn("mosstts_drain_build", [_p, _p, ctypes.POINTER(CondArgs), ctypes.POINTER(DrainArgs),
                                     _p, _p, _p, ctypes.POINTER(_p)])
    graphs = (_p * nb)(*prefill_graphs)
    gptrs = (_p * nb)(*[g.data_ptr() for g in gathers])
    ngs = (_i * nb)(*[g.shape[0] for g in gathers])
    rc = fn(step_graph, graphs, ctypes.byref(cargs), ctypes.byref(dargs), gptrs, ngs,
            handles.data_ptr(), ctypes.byref(exec_out))
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
