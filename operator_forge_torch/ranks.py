"""Run a function in ``n`` spawned ranks of one ``torch.distributed``
process group.

Each rank is a process of the ``spawn`` start method, so it imports only
the module that defines the function it runs.  The ranks meet through a
``file://`` rendezvous in a temporary directory (no TCP port), on NCCL with
one card a rank for ``"cuda"`` and on gloo with one thread a rank for
``"cpu"``.  The parent waits with a deadline of its own: a rank that fails
or hangs ends the run with an error, and no rank outlives it.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, n: int, device_type: str, tmp: str, results) -> None:
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n)
    value = fn(*args)
    results.put((rank, value))
    dist.destroy_process_group()


def run_ranks(n: int, fn, args: tuple = (), device_type: str = "cuda", timeout: float = 600.0) -> list:
    """Call ``fn(*args)`` in each of ``n`` new ranks, once the default
    process group holds them all, and return the values in rank order
    (they travel back pickled: return plain data).  ``fn`` must be
    importable by name.  Raises if a rank exits with an error, if the
    ranks have not all returned within ``timeout`` seconds, and for
    ``"cuda"`` if there are fewer cards than ranks (NCCL refuses two ranks
    on one card)."""
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"{n} ranks need {n} CUDA devices, this machine has {torch.cuda.device_count()}"
        )
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    values: dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the call goes through a file: a process's start writes its
        # arguments into a pipe, and a rank that dies before reading them
        # all would block that write past any deadline
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [
            ctx.Process(target=_rank_main, args=(rank, n, device_type, tmp, results), daemon=True)
            for rank in range(n)
        ]
        deadline = time.monotonic() + timeout
        try:
            for proc in procs:
                proc.start()
            while len(values) < n:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n - len(values)} of {n} ranks had not returned after {timeout} s")
                try:
                    rank, value = results.get(timeout=0.5)
                    values[rank] = value
                except queue.Empty:
                    failed = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if failed:
                        raise RuntimeError(f"ranks exited with errors (rank, exit code): {failed}")
            for proc in procs:
                proc.join(max(0.0, deadline - time.monotonic()))
            failed = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(f"ranks did not exit cleanly (rank, exit code): {failed}")
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    return [values[rank] for rank in range(n)]
