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
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import torch

STATE_FILE, META_FILE = "state.pt", "trainer.json"


class SaveHandle:
    """What ``save_train_state`` returns: ``wait_until_finished()`` returns
    once ``state.pt`` is written (raising what the writer raised)."""

    def __init__(self, thread: threading.Thread | None = None):
        self._thread = thread
        self.error: BaseException | None = None

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error


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
    with open(path / META_FILE, "w") as f:
        json.dump({"family": trainer.family, "step": trainer.step_idx,
                   "history": trainer.history}, f)
    if not use_async:
        torch.save(state, path / STATE_FILE)
        return SaveHandle()

    def write():
        try:
            torch.save(state, path / STATE_FILE)
        except BaseException as e:  # handed to wait_until_finished
            handle.error = e

    handle = SaveHandle(threading.Thread(target=write, name="train-state-save"))
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
    params = dict(trainer.params.named_parameters())
    if set(state["params"]) != set(params):
        raise KeyError("checkpoint and trainer parameter names differ")
    for name, p in params.items():
        p.copy_(state["params"][name])
    trainer.opt.load_state_dict(state["opt_state"])
    trainer.step_idx = int(state["step"])
    trainer.history = list(meta.get("history", []))
