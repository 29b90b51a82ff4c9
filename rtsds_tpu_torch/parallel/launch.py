"""Run a function on N ranks of a fresh process group, each in its own
process: the tests' and the card smoke's way to drive the data axis.

    results = run_ranks(fn, 2, args, backend="gloo", timeout_s=60)

Each child is started with the ``spawn`` method (CUDA forbids ``fork``
after its init), joins a group on ``tcp://127.0.0.1:<free port>``, runs
``fn(rank, world_size, *args)`` inside :func:`data_parallel` and sends its
result back.  A child that raises, or a run that outlasts ``timeout_s``,
kills every child and raises here, so a hung collective fails one call
instead of the whole run.  ``fn`` must be importable by the children (a
module-level function), and its result picklable: it crosses as bytes,
tensors by value (torch's queue would share them through file
descriptors, which close when the child exits).
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rtsds_tpu_torch.parallel.distributed import data_parallel


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, world_size, port, backend, fn, args, threads, env, out):
    try:
        os.environ.update(env)
        if threads:
            torch.set_num_threads(threads)
        if backend is None:  # fn joins the group itself (--multihost)
            os.environ.update({
                "RTSDS_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "RTSDS_NUM_PROCESSES": str(world_size),
                "RTSDS_PROCESS_ID": str(rank)})
            out.put((rank, True, pickle.dumps(fn(rank, world_size, *args))))
            return
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world_size, rank=rank)
        try:
            with data_parallel():
                result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:  # reported to the parent, which fails the run
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, args: tuple = (),
              backend: str | None = "gloo",
              timeout_s: float = 60.0, threads: int | None = 1,
              env: dict | None = None) -> list:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]`` from
    ``world_size`` spawned ranks; ``threads`` sets each child's torch
    threads, ``env`` adds to each child's environment.  ``backend=None``
    joins no group and sets the ``RTSDS_*`` variables instead, for a
    ``fn`` that runs ``--multihost``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, world_size, port, backend, fn, args,
                               threads, env or {}, out), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks of {fn.__name__} did not finish "
                    f"within {timeout_s} s (ranks done: {sorted(results)})")
            try:
                rank, ok, result = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {fn.__name__} "
                                       f"died without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                                   f"{result}")
            results[rank] = pickle.loads(result)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        out.close()
    return [results[r] for r in range(world_size)]
