"""The scheduler core the three continuous-batching servers share.

``DelayBatchServer``, ``RealtimeBatchServer`` and ``LocalBatchServer``
(``batch_server.py``, ``realtime_batch_server.py``,
``local_batch_server.py``) differ in admission, splice and how a finished
slot's output is trimmed; they poll alike:

- ``request_seed``: a request's key seed, an int-only hash (string
  tuples are salted per process), salted per server family.
- ``snap_flags``: start copying a state's stop flags to the host. On the
  card this is a non-blocking copy into pinned memory and an event recorded
  after it, so a later read waits for the copy only, not for the frames
  enqueued behind it.
- ``run_pipelined``: the pipelined ``run`` loop. The stop flags are
  snapshotted at a poll boundary, the next block is enqueued, and only
  then is the snapshot read, so each poll's host round trip hides behind
  device work. EOS is seen up to one block late (frozen frames that the
  server's trim drops); budget completions come from the host mirrors and
  stay exact.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def request_seed(salt: int, key: int) -> int:
    """A request's key seed (``PRNGKey`` of it): ``hash((salt, key))`` kept to 31 bits.
    Integers hash alike in every process, so a seed reproduces across
    processes and server lifetimes."""
    return hash((salt, key)) & 0x7FFFFFFF


def snap_flags(flags: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start copying ``flags`` to the host: ``(host copy, event)``, the
    event None on the CPU (where the copy is done on return)."""
    if flags.device.type != "cuda":
        return flags.clone(), None
    host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
    host.copy_(flags, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def run_pipelined(server, dispatch: Callable[[int], int],
                  stop_flags: Callable[[], torch.Tensor], max_steps: int) -> List:
    """Drain ``server``'s queue and active slots; completions in finish
    order. ``server`` has ``slots``, ``_active`` (slot -> request with a
    ``request_id``), ``_queue`` and ``_collect(stopped=...)``, which
    completes the slots flagged in ``stopped`` and those whose host step
    count reached their budget. ``dispatch(room)`` admits and enqueues one
    poll window of at most ``room`` steps and returns the steps it ran;
    ``stop_flags()`` is the device state's (slots,) stop flags.

    Each round: complete the slots whose budget the host knows is spent (so
    the window admits into them), dispatch a window, then read the flags
    snapshotted before it. A slot freed and readmitted since the snapshot
    carries the old occupant's flag, so only unchanged occupants' flags are
    trusted. The loop ends when nothing is left, or when a window ran no
    step (``max_steps`` spent, or nothing could be admitted)."""
    done: List = []
    pending = None  # (flag snapshot, its event, slot -> request_id)
    steps = 0
    while True:
        if server._active:
            done.extend(server._collect(stopped=np.zeros(server.slots, bool)))
        did = 0
        if steps < max_steps and (server._active or server._queue):
            did = dispatch(max_steps - steps)
            steps += did
        if pending is not None:
            host, event, snap_rids = pending
            if event is not None:
                event.synchronize()
            host = host.numpy()
            stopped = np.zeros(server.slots, bool)
            for slot, rid in snap_rids.items():
                req = server._active.get(slot)
                if req is not None and req.request_id == rid:
                    stopped[slot] = host[slot]
            done.extend(server._collect(stopped=stopped))
            pending = None
        if not (server._active or server._queue):
            break
        if did == 0:
            if server._queue:
                logging.getLogger(__name__).warning(
                    "run() stopping with %d undrained request(s) still queued (ids %s)",
                    len(server._queue), [r.request_id for r in server._queue])
            break
        if server._active:
            pending = (*snap_flags(stop_flags()),
                       {s: r.request_id for s, r in server._active.items()})
    return done
