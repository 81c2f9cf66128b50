"""Resumable training state: parameters, optimizer state and step.

Ports ``mosstts_tpu/train/checkpoint.py`` (``save_train_state``,
``restore_train_state``). ``TTSTrainer.save`` writes the model in the
serving format, which drops the optimizer moments, so a preempted run would
restart cold; this module writes the whole train state instead:
``<path>/state.pt`` (``torch.save`` of {"params": name -> tensor,
"opt_state": the optimizer's ``state_dict``, "step"}) and
``<path>/trainer.json`` (family, step and loss history), as the JAX package
writes its ``trainer.json``. The JAX package stores its state through
orbax; the port's format is its own and reads no orbax directory (the
serving format, ``utils/save.py``, is the one both packages share).

A trainer sharded over a mesh (``TTSTrainer(mesh=)`` or ``pipeline=``)
saves per rank: rank r writes its blocks of the split parameters and their
optimizer state to ``state.rank<r>.pt``, rank 0 the replicated ones, the
step and ``trainer.json``; every rank waits for the others before
returning. Restoring onto the same mesh reads ``state.pt`` and the rank's
own file, so every tensor comes back bit for bit.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import torch
import torch.distributed as dist

STATE_FILE, META_FILE = "state.pt", "trainer.json"


def rank_file(rank: int) -> str:
    return f"state.rank{rank}.pt"


class SaveHandle:
    """What ``save_train_state`` returns: ``wait_until_finished()`` returns
    once ``state.pt`` is written (raising what the writer raised)."""

    def __init__(self, thread: threading.Thread | None = None, barrier: bool = False):
        self._thread = thread
        self._barrier = barrier  # a sharded save: every rank's files, once waited for
        self.error: BaseException | None = None

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._barrier:
            dist.barrier()
            self._barrier = False
        if self.error is not None:
            raise self.error


def _split(state: dict, names) -> tuple:
    """(the entries of ``state`` named in ``names``, the others), at every
    level of name-keyed dicts (params and each optimizer moment)."""
    mine, rest = {}, {}
    for k, v in state.items():
        if isinstance(v, dict):
            mine[k] = {n: t for n, t in v.items() if n in names}
            rest[k] = {n: t for n, t in v.items() if n not in names}
        else:
            rest[k] = v
    return mine, rest


def _merge(a: dict, b: dict) -> dict:
    out = dict(b)
    for k, v in a.items():
        out[k] = {**out.get(k, {}), **v} if isinstance(v, dict) else v
    return out


def _host_copy(state):
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    return state


def save_train_state(path, trainer, *, use_async: bool = False) -> SaveHandle:
    """Write {params, opt_state, step} to ``<path>/state.pt`` and
    ``trainer.json``. With ``use_async=True`` the state is copied to host
    memory now and written on a thread while training goes on; call
    ``wait_until_finished()`` on the returned handle before relying on the
    file."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = {"params": dict(trainer.params.named_parameters()),
             "opt_state": trainer.opt.state_dict(), "step": trainer.step_idx}
    state = _host_copy(state)
    files = {STATE_FILE: state}
    sharded = getattr(trainer, "sharded", False)
    if sharded:  # this rank's blocks; rank 0 also the replicated rest
        names = set(trainer.sharded_names())
        (p_mine, p_rest), (o_mine, o_rest) = (_split({"params": state["params"]}, names),
                                              _split(state["opt_state"], names))
        rank = dist.get_rank()
        files = {rank_file(rank): {"params": p_mine["params"], "opt_state": o_mine}}
        if rank == 0:
            files[STATE_FILE] = {"params": p_rest["params"], "opt_state": o_rest,
                                 "step": state["step"]}
    if not sharded or dist.get_rank() == 0:
        with open(path / META_FILE, "w") as f:
            json.dump({"family": trainer.family, "step": trainer.step_idx,
                       "history": trainer.history}, f)

    def write():
        for name, part in files.items():
            torch.save(part, path / name)

    if not use_async:
        write()
        handle = SaveHandle(barrier=sharded)
        handle.wait_until_finished()
        return handle

    def write_async():
        try:
            write()
        except BaseException as e:  # handed to wait_until_finished
            handle.error = e

    handle = SaveHandle(threading.Thread(target=write_async, name="train-state-save"),
                        barrier=sharded)
    handle._thread.start()
    return handle


@torch.no_grad()
def restore_train_state(path, trainer) -> None:
    """Restore in place into a freshly made ``TTSTrainer`` of the same
    family, configuration and optimizer: parameters, optimizer moments,
    step counter and loss history, each tensor copied into the trainer's
    own (its dtype and device kept). A checkpoint of another family
    raises ``ValueError``."""
    path = Path(path)
    meta = json.loads((path / META_FILE).read_text())
    if meta.get("family") != trainer.family:
        raise ValueError(f"checkpoint family {meta.get('family')!r} != trainer "
                         f"{trainer.family!r}")
    state = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    if getattr(trainer, "sharded", False):
        mine = torch.load(path / rank_file(dist.get_rank()), map_location="cpu",
                          weights_only=True)
        state = {"params": {**state["params"], **mine["params"]},
                 "opt_state": _merge(mine["opt_state"], state["opt_state"]),
                 "step": state["step"]}
    params = dict(trainer.params.named_parameters())
    if set(state["params"]) != set(params):
        raise KeyError("checkpoint and trainer parameter names differ")
    for name, p in params.items():
        p.copy_(state["params"][name])
    trainer.opt.load_state_dict(state["opt_state"])
    trainer.step_idx = int(state["step"])
    trainer.history = list(meta.get("history", []))
