"""Run a function in N ranks joined by a process group, from one process.

``spawn_ranks(fn, n, args, backend=..., device=...)`` starts N processes
with ``torch.multiprocessing`` (start method ``spawn``: CUDA does not
survive ``fork``), joins them through ``tcp://localhost:<free port>``,
calls ``fn(mesh_rank, *args)`` in each (``mesh_rank`` is
``(rank, world_size, device)``) and returns each rank's return value, in
rank order, through ``torch.save`` files in a temporary directory.  The
function and its arguments reach the ranks through a file there too: a
spawn start writes what it hands a child into a pipe, and a payload past
the pipe's buffer blocks the parent until that child has started, so the
ranks would start one after another.  A rank that raises makes
``spawn_ranks`` raise; nothing is caught.  A CPU rank runs torch on one
thread, so that N ranks do not starve each other (or other processes) of
cores.
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile

import torch

__all__ = ["free_port", "spawn_ranks"]


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _rank_main(rank, world_size, backend, device, init_method, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_workers
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    r, w, dev = init_workers(backend, rank=rank, world_size=world_size,
                             init_method=init_method, device=device)
    try:
        out = fn((r, w, dev), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), *, backend: str = "gloo",
                device: str = "cuda") -> list:
    """``fn((rank, world_size, device), *args)`` in ``world_size`` spawned
    ranks; returns their results in rank order.  ``fn`` must be importable
    by name (a module-level function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks_") as out_dir:
        init_method = f"tcp://127.0.0.1:{free_port()}"
        with open(os.path.join(out_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        mp.start_processes(_rank_main, args=(world_size, backend, device,
                                             init_method, out_dir),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
