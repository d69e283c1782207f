"""Start the ranks of a data-parallel run as processes.

``run_ranks(fn, n, ...)`` spawns n processes; each joins the process
group (``init_mesh``: a ``file://`` rendezvous in a fresh directory),
runs ``fn(mesh, *args)`` and sends its result back.  The parent reads
the results in rank order, and raises when a rank raised (with every
failed rank's traceback), died or did not finish within ``timeout``
seconds; it stops every rank it started before it returns or raises.  ``fn`` and ``args`` are pickled: ``fn``
must be importable by name (a module-level function).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from pynqs_tpu_torch.parallel.mesh import init_mesh

__all__ = ["run_ranks", "rank_device"]


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, or under NCCL card ``rank``, or
    under gloo card ``rank`` modulo the cards (ranks may share one)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and rank >= n_cards:
        raise RuntimeError(f"NCCL needs one card per rank: rank {rank}, {n_cards} card(s)")
    return torch.device("cuda", rank % n_cards)


def _rank_main(fn, rank, world, backend, device, init_method, num_threads, args, out):
    try:
        if num_threads is not None:
            torch.set_num_threads(num_threads)
        mesh = init_mesh(backend, init_method, rank, world, rank_device(device, rank, backend))
        out.put((rank, "ok", fn(mesh, *args)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        # queued before the process group closes: the other ranks fail on
        # the closed connections only after this report
        out.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _raise_failed(first: int, tb: str, out, procs, grace: float = 5.0):
    """Raise with the tracebacks of every rank that fails within ``grace``
    seconds of the first (a rank's failure makes the others fail in their
    collectives, and the first report need not be the cause)."""
    errors = {first: tb}
    end = time.monotonic() + grace
    while time.monotonic() < end and (any(p.exitcode is None for p in procs)
                                      or not out.empty()):
        try:
            rank, status, res = out.get(timeout=0.2)
        except queue.Empty:
            continue
        if status == "error":
            errors[rank] = res
    raise RuntimeError(f"run_ranks: rank(s) {sorted(errors)} failed:\n"
                       + "".join(f"--- rank {r} ---\n{errors[r]}" for r in sorted(errors)))


def run_ranks(fn, n: int, *, backend: str, device, args: tuple = (), timeout: float = 600.0,
              rendezvous_dir: str | None = None, num_threads: int | None = None) -> list:
    """[fn(mesh of rank r, *args) for r in range(n)], each in its own
    process.  ``rendezvous_dir``: where the rendezvous file goes (a fresh
    temporary directory by default, removed after)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rendezvous", dir=rendezvous_dir)
    init_method = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, str(device), init_method, num_threads, args,
                               out))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + timeout
        while len(results) < n:
            try:
                rank, status, res = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {n - len(results)} rank(s) did not finish "
                                       f"within {timeout} s") from None
                # a rank that exited has flushed its result into the queue
                gone = [r for r, p in enumerate(procs) if p.exitcode is not None
                        and r not in results]
                if gone and out.empty():
                    raise RuntimeError(f"run_ranks: rank(s) {gone} ended without a result "
                                       f"(exit codes {[procs[r].exitcode for r in gone]})")
                continue
            if status == "error":
                _raise_failed(rank, res, out, procs)
            results[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
