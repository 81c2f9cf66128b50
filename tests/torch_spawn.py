"""Run a function on N gloo ranks, each in its own spawned process: the
helper of the port's parallel tests (``tests/test_torch_parallel_*.py``).

The rendezvous is a ``FileStore`` under the test's ``tmp_path`` (no TCP
port, so pytest-xdist workers cannot collide); each rank runs one torch
thread; the ranks are joined with a deadline and terminated when it
passes, so a deadlocked send or receive fails the test instead of holding
the run. ``fn(rank, world, *args)`` must be importable by name (a module
that imports no JAX: ``torch_parallel_ranks``); what rank 0 returns comes
back through a file.
"""
from __future__ import annotations

import os
import time
import traceback
import uuid

import torch
import torch.multiprocessing as mp

DEADLINE = 120.0  # seconds for all ranks


def _entry(fn, rank: int, world: int, store: str, out: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        result = fn(rank, world, *args)
        if rank == 0:
            torch.save(result, out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}.err{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args, deadline: float = DEADLINE):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; rank 0's result.
    Raises if a rank fails (with its traceback) or the deadline passes."""
    ctx = mp.get_context("spawn")
    tag = uuid.uuid4().hex
    store, out = str(tmp_path / f"store-{tag}"), str(tmp_path / f"out-{tag}.pt")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    # wait for every rank, or stop at the first that fails (its peers would
    # wait in a collective for it until the deadline)
    while any(p.is_alive() for p in procs) and time.monotonic() < end:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    failed = any(p.exitcode not in (None, 0) for p in procs)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    for p in alive:
        p.join(5)
    errors = []
    for r in range(world):
        if os.path.exists(f"{out}.err{r}"):
            with open(f"{out}.err{r}") as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors:
        raise RuntimeError("\n".join(errors))
    if alive and not failed:
        raise TimeoutError(f"{len(alive)} of {world} ranks still running after {deadline} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return torch.load(out, weights_only=False)
