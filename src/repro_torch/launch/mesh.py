"""The worker mesh: the ranks of a ``torch.distributed`` process group
laid out as K decentralized workers, each of ``model_axis`` ranks.

Port of ``src/repro/launch/mesh.py:22-42`` and of
``src/repro/launch/sharding.py:32-84``'s ``Layout``/``make_layout``.  Where
the reference lays the devices on the named axes of a mesh and runs each
worker's shard inside ``shard_map``, the port runs one process per device:
:func:`init_workers` joins the process group, :func:`make_mesh` lays the
ranks on the named worker axes and, above 1, a trailing ``"model"`` axis,
in row-major order (rank = worker index · tp + model coordinate, as
``jax.make_mesh((K, tp), ("data", "model"))`` lays the devices out; the
worker index is ``DenseComm``'s), and builds every per-axis subgroup and
the group of the ranks that share a model coordinate, on every rank in
the same order, once.  The model axis carries profile A's tensor
parallelism (:mod:`repro_torch.launch.sharding`); the mesh also holds the
host staging of the gloo wire on a card (:meth:`WorkerMesh.pinned`,
:meth:`WorkerMesh.all_reduce`), which the gossip and the TP collectives
share.

The backend is an explicit argument: ``"nccl"`` needs one GPU per rank on
the host; ``"gloo"`` runs anywhere, and runs several ranks on one card
(all on ``cuda:0``) with the wire through the host.  Profile B (FSDP
inside a worker) and ``inner="dp"`` are refused: ROADMAP queue A item
12b.4.  Importing this module creates no process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "Layout", "MODEL_AXIS", "WorkerMesh", "init_workers",
           "make_layout", "make_mesh", "rank_device"]

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


MODEL_AXIS = "model"


@dataclasses.dataclass
class WorkerMesh:
    """The ranks of the process group laid out row-major on named axes:
    the worker axes, then ``"model"`` where a worker spans several ranks.
    ``coords`` are this rank's coordinates; ``groups[name]`` is the
    subgroup of the ranks that share every coordinate but ``name``'s with
    this one (``None``: the whole group); ``worker_group`` the ranks that
    share this one's model coordinate (``None``: the whole group).
    ``backend`` is the process group's, which decides whether a CUDA
    payload is staged through host buffers (gloo) or handed to the
    library as it is (NCCL)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)
    worker_group: object = None
    _host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def world_size(self) -> int:
        return int(math.prod(self.axis_sizes))

    @property
    def model_size(self) -> int:
        """Ranks per worker: the model axis's size (1 without one)."""
        if MODEL_AXIS not in self.axis_names:
            return 1
        return int(self.axis_sizes[self.axis_index(MODEL_AXIS)])

    @property
    def model_coord(self) -> int:
        """This rank's coordinate on the model axis (0 without one)."""
        if MODEL_AXIS not in self.axis_names:
            return 0
        return self.coords[self.axis_index(MODEL_AXIS)]

    @property
    def n_workers(self) -> int:
        return self.world_size // self.model_size

    @property
    def worker(self) -> int:
        """This rank's worker: its row-major index over the worker axes."""
        return self.rank // self.model_size

    def worker_rank(self, worker: int, model: Optional[int] = None) -> int:
        """The rank of ``worker`` at model coordinate ``model`` (this
        rank's by default)."""
        c = self.model_coord if model is None else int(model)
        return (int(worker) % self.n_workers) * self.model_size + c

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

    def pinned(self, key, t):
        """The pinned host buffer of ``key`` for a tensor shaped as ``t``,
        allocated once per key, shape and dtype.  Every user stages on
        the rank's one stream and synchronizes it before posting, so a
        buffer is free again by its next use."""
        key = key + (tuple(t.shape), t.dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def all_reduce(self, t, group, op=dist.ReduceOp.SUM):
        """In-place ``all_reduce`` of ``t`` over ``group``; on a card under
        gloo through a pinned host buffer (copied in, the stream
        synchronized, reduced, copied back)."""
        if not self.staged:
            dist.all_reduce(t, op=op, group=group)
            return t
        h = self.pinned(("reduce",), t)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h, non_blocking=True)
        return t


def make_mesh(axis_sizes, axis_names, *, device: torch.device,
              model_axis: int = 1) -> WorkerMesh:
    """The mesh over the initialized process group: the worker grid
    ``axis_sizes`` on ``axis_names`` and, for ``model_axis > 1``, a
    trailing ``"model"`` axis of that many ranks per worker, with every
    subgroup built (collective: every rank calls this with the same
    arguments)."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis sizes {axis_sizes} vs names {axis_names}")
    if MODEL_AXIS in axis_names:
        raise ValueError(f"{MODEL_AXIS!r} is the model axis: pass its size "
                         "as model_axis, not as a worker axis")
    tp = int(model_axis)
    if tp < 1:
        raise ValueError(f"model axis {tp}: at least 1 rank per worker")
    if tp > 1:
        axis_sizes, axis_names = axis_sizes + (tp,), axis_names + (
            MODEL_AXIS,)
    world = dist.get_world_size()
    if math.prod(axis_sizes) != world:
        raise ValueError(f"mesh {axis_sizes} ({axis_names}) holds "
                         f"{math.prod(axis_sizes)} ranks; the process "
                         f"group has {world}")
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
    if tp > 1:
        if len(axis_sizes) == 2:
            mesh.worker_group = mesh.groups[axis_names[0]]
        else:
            # the ranks of every model coordinate, on every rank, in order
            for c in range(tp):
                g = dist.new_group([w * tp + c
                                    for w in range(world // tp)])
                if mesh.model_coord == c:
                    mesh.worker_group = g
    return mesh


@dataclasses.dataclass(frozen=True)
class Layout:
    """The reference's ``Layout`` for profile A: the gossip axes of the
    mesh and the tensor-parallel axis inside a worker (None: a worker is
    one rank)."""
    mesh: WorkerMesh
    worker_axes: Tuple[str, ...]
    tp_axis: Optional[str] = None

    @property
    def worker_sizes(self) -> Tuple[int, ...]:
        return tuple(self.mesh.axis_sizes[self.mesh.axis_index(a)]
                     for a in self.worker_axes)

    @property
    def n_workers(self) -> int:
        return int(math.prod(self.worker_sizes)) if self.worker_axes else 1

    @property
    def tp_size(self) -> int:
        return self.mesh.model_size if self.tp_axis else 1

    @property
    def worker_index(self) -> int:
        """This rank's global worker index (row-major over the worker
        axes): which worker's batches it draws."""
        if self.tp_axis is None:
            return self.mesh.rank
        return self.mesh.worker


def make_layout(parallel, mesh: WorkerMesh) -> Layout:
    """Profile A (``src/repro/launch/sharding.py:62-78``): the mesh's
    worker axes gossip and ``"model"``, where the mesh has one, is the
    tensor-parallel axis inside each worker; with ``inner="worker"``
    every axis, the model axis too, is a worker axis.  Profile B (FSDP
    inside a worker) and ``inner="dp"`` are refused: item 12b.4."""
    if parallel.profile != "A":
        raise NotImplementedError(
            f"profile {parallel.profile!r}: FSDP inside a worker is not "
            "ported yet (ROADMAP queue A item 12b.4)")
    names = tuple(mesh.axis_names)
    if MODEL_AXIS not in names or parallel.inner == "worker":
        return Layout(mesh, names)
    if parallel.inner != "tp":
        raise NotImplementedError(
            f"inner={parallel.inner!r}: data parallelism inside a worker "
            "over the model axis is not ported yet (ROADMAP queue A item "
            "12b.4); inner='tp' shards the worker's params over it")
    return Layout(mesh, tuple(n for n in names if n != MODEL_AXIS),
                  MODEL_AXIS)
