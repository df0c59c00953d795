"""The worker mesh: one decentralized worker per rank of a
``torch.distributed`` process group.

Port of the worker part of ``src/repro/launch/mesh.py:22-42`` and of
``src/repro/launch/sharding.py:32-52``'s ``Layout``.  Where the reference
lays the K workers on the named axes of a device mesh and runs each
worker's shard inside ``shard_map``, the port runs one process per worker:
:func:`init_workers` joins the process group, :func:`make_mesh` lays the
ranks on the named worker axes in row-major order (rank = the worker index
of ``DenseComm``'s grid) and builds every per-axis subgroup, on every rank
in the same order, once.

The backend is an explicit argument: ``"nccl"`` needs one GPU per rank on
the host; ``"gloo"`` runs anywhere, and runs several ranks on one card
(all on ``cuda:0``) with the wire through the host.  A ``model`` axis above
1 (tensor parallelism inside a worker, the reference's profiles A/B) is
refused: ROADMAP queue A item 12b.  Importing this module creates no
process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "Layout", "WorkerMesh", "init_workers", "make_layout",
           "make_mesh", "rank_device"]

BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def rank_device(device: str, local_rank: int,
                local_world_size: int) -> torch.device:
    """This rank's device: ``cpu`` only when asked; ``cuda:{local_rank}``
    when the host has a card per rank, else ``cuda:0`` for every rank (the
    ranks share one card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: the ranks run on 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the ranks on the CPU")
    if dev.index is not None:
        return dev
    if torch.cuda.device_count() >= local_world_size:
        return torch.device("cuda", local_rank)
    return torch.device("cuda", 0)


def init_workers(backend: str, *, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 init_method: Optional[str] = None,
                 device: str = "cuda") -> Tuple[int, int, torch.device]:
    """Join the process group; returns ``(rank, world_size, device)``.

    Without ``rank``/``world_size`` the rank reads ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); a spawning
    caller passes them and ``init_method`` (``tcp://localhost:<port>``),
    and its ranks share one host.  ``backend`` is ``"nccl"`` or
    ``"gloo"``; NCCL is refused when the host has fewer GPUs than ranks."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if rank is None:
        rank, world_size = _env_int("RANK"), _env_int("WORLD_SIZE")
        if rank is None or world_size is None:
            raise ValueError(
                "init_workers: pass rank and world_size, or run under "
                "torchrun (RANK and WORLD_SIZE unset)")
        local_rank = _env_int("LOCAL_RANK") or 0
        local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
        init_method = init_method or "env://"
    else:
        if world_size is None or init_method is None:
            raise ValueError("init_workers: a spawned rank needs "
                             "world_size and init_method too")
        local_rank, local_world = rank, world_size
    if backend == "nccl":
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_gpu < local_world:
            raise ValueError(
                f"backend 'nccl' needs one GPU per rank: {local_world} ranks "
                f"on this host, {n_gpu} GPU(s); NCCL puts no two ranks on "
                "one device.  Use --dist-backend gloo to share a card (the "
                "wire then goes through the host)")
    dev = rank_device(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return rank, world_size, dev


@dataclasses.dataclass
class WorkerMesh:
    """The ranks of the process group laid out row-major on named worker
    axes.  ``coords`` are this rank's coordinates; ``groups[name]`` is the
    subgroup of the ranks that share every coordinate but ``name``'s with
    this one (``None``: the whole group).  ``backend`` is the process
    group's, which decides whether a CUDA payload is staged through host
    buffers (gloo) or handed to the library as it is (NCCL)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def world_size(self) -> int:
        return int(math.prod(self.axis_sizes))

    @property
    def coords(self) -> Tuple[int, ...]:
        out, r = [], self.rank
        for n in reversed(self.axis_sizes):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def rank_at(self, coords) -> int:
        """The rank at the row-major ``coords``."""
        r = 0
        for c, n in zip(coords, self.axis_sizes):
            r = r * n + int(c) % n
        return r

    def peer(self, name: str, shift: int) -> int:
        """The rank ``shift`` further along axis ``name`` (wrapping)."""
        ax = self.axis_index(name)
        c = list(self.coords)
        c[ax] = (c[ax] + shift) % self.axis_sizes[ax]
        return self.rank_at(c)

    @property
    def staged(self) -> bool:
        """Whether payloads on the card go through pinned host buffers:
        the gloo wire takes host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(axis_sizes, axis_names, *, device: torch.device,
              model_axis: int = 1) -> WorkerMesh:
    """The worker mesh over the initialized process group, with every
    per-axis subgroup built (collective: every rank calls this with the
    same arguments).  ``model_axis > 1`` is refused."""
    if int(model_axis) != 1:
        raise NotImplementedError(
            f"model axis {model_axis}: tensor parallelism inside a worker "
            "(the reference's profiles A/B) is not ported yet (ROADMAP "
            "queue A item 12b); the port runs one worker per rank")
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis sizes {axis_sizes} vs names {axis_names}")
    world = dist.get_world_size()
    if math.prod(axis_sizes) != world:
        raise ValueError(f"worker grid {axis_sizes} holds "
                         f"{math.prod(axis_sizes)} workers; the process "
                         f"group has {world} ranks")
    mesh = WorkerMesh(axis_names, axis_sizes, dist.get_rank(),
                      torch.device(device), dist.get_backend())
    if len(axis_sizes) > 1:
        for ax, name in enumerate(axis_names):
            # every line along axis ``ax``, on every rank, in one order
            others = [n for i, n in enumerate(axis_sizes) if i != ax]
            for flat in range(math.prod(others)):
                fixed, rem = [], flat
                for n in reversed(others):
                    fixed.append(rem % n)
                    rem //= n
                fixed = list(reversed(fixed))
                ranks = []
                for c in range(axis_sizes[ax]):
                    co = fixed[:ax] + [c] + fixed[ax:]
                    ranks.append(mesh.rank_at(co))
                g = dist.new_group(ranks)
                if mesh.rank in ranks:
                    mesh.groups[name] = g
    else:
        mesh.groups[axis_names[0]] = None
    return mesh


@dataclasses.dataclass(frozen=True)
class Layout:
    """The worker part of the reference's ``Layout``: the gossip axes of
    the mesh.  Inside a worker nothing is sharded in the port."""
    mesh: WorkerMesh
    worker_axes: Tuple[str, ...]

    @property
    def worker_sizes(self) -> Tuple[int, ...]:
        return tuple(self.mesh.axis_sizes[self.mesh.axis_index(a)]
                     for a in self.worker_axes)

    @property
    def n_workers(self) -> int:
        return int(math.prod(self.worker_sizes)) if self.worker_axes else 1

    @property
    def worker_index(self) -> int:
        """This rank's global worker index (row-major over the worker
        axes): which worker's batches it draws."""
        return self.mesh.rank


def make_layout(parallel, mesh: WorkerMesh) -> Layout:
    """Profile A with one worker per rank: every mesh axis is a worker
    axis.  Profile B (FSDP inside a worker) is refused: item 12b."""
    if parallel.profile != "A":
        raise NotImplementedError(
            f"profile {parallel.profile!r}: FSDP inside a worker is not "
            "ported yet (ROADMAP queue A item 12b)")
    return Layout(mesh, tuple(mesh.axis_names))
