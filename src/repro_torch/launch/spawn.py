"""Several ``torch.distributed`` ranks on one host, without ``torchrun``.

``run_world(fn, world, rdv_dir, *args)`` starts ``world`` processes with
the ``spawn`` start method (forking a process that has threads running, as
one with JAX or CUDA loaded does, is unsafe), joins them into one gloo
group through a ``file://`` rendezvous under ``rdv_dir`` (no TCP port, so
concurrent worlds never collide), runs ``fn(rank, world, *args)`` in each
and returns the ranks' results in rank order. ``fn`` must be importable by
name (a module-level function) and its arguments and result picklable. A
rank that raises fails the world with its traceback; a world that does not
finish within ``timeout`` seconds is killed and raises.

gloo is the backend because NCCL refuses two ranks on one card: the tests
run their ranks on the CPU, and ``chip_smoke.py`` runs several ranks on
its one card (``launch.mesh`` stages gloo's collectives of CUDA tensors
through the host). Every rank finds the group in place, so
``launch.mesh.make_local_mesh`` and the trainer use it as they would under
``torchrun``.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback


def _entry(fn, rank, world, rdv, out, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world)
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))   # for the parent
        raise


def run_world(fn, world: int, rdv_dir: str, *args, timeout: float = 300):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; returns
    their results in rank order, or raises with a failed rank's traceback
    or on a hang."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(rdv_dir, exist_ok=True)
    rdv = os.path.join(rdv_dir, f"rdv_{time.monotonic_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, rdv, out, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} did not finish in "
                                   f"{timeout} s (ranks done: "
                                   f"{sorted(results)})")
            try:
                rank, status, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       f"result") from None
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
