"""The worker mesh: the ranks of a ``torch.distributed`` process group
laid out on named axes, and the layout that gives those axes their roles.

Port of ``src/repro/launch/mesh.py:22-42`` and of
``src/repro/launch/sharding.py:32-84``'s ``Layout``/``make_layout``.  Where
the reference lays the devices on the named axes of a mesh and runs each
worker's shard inside ``shard_map``, the port runs one process per device:
:func:`init_workers` joins the process group, :func:`make_mesh` lays the
ranks on the named axes and, above 1, a trailing ``"model"`` axis, in
row-major order (as ``jax.make_mesh((K, tp), ("data", "model"))`` lays
the devices out), and builds, on every rank in the same order, once, the
subgroup of every line over one axis and, on a mesh of two or more
named axes and a model axis, the ``pod × data`` group of a profile A model
coordinate.  :func:`make_layout` then says, as the reference does, which
axes gossip between workers and which split a worker: the TP axis, the
FSDP axis (profile B) or the inner data-parallel axis (profile A,
``inner="dp"``).  A worker's index and its ranks follow from the layout
(:class:`Layout`), never from one axis's name.  The mesh also holds the
collectives that the gossip, the TP and the FSDP paths share
(:meth:`WorkerMesh.p2p`, :meth:`WorkerMesh.all_reduce`,
:meth:`WorkerMesh.all_gather`, :meth:`WorkerMesh.reduce_scatter`): NCCL's
own on cards, and on a card under gloo staged through the pinned host
buffers of :meth:`WorkerMesh.staging`.

The backend is an explicit argument: ``"nccl"`` needs one GPU per rank on
the host; ``"gloo"`` runs anywhere, and runs several ranks on one card
(all on ``cuda:0``) with the wire through the host.  Importing this
module creates no process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "DATA_AXIS", "HW", "INNER_TAG", "Layout",
           "MODEL_AXIS", "POD_AXIS", "WorkerMesh", "init_workers",
           "make_layout", "make_mesh", "rank_device"]

BACKENDS = ("nccl", "gloo")


class HW:
    """The card the roofline terms are taken on (the counterpart of the
    reference's ``HW``, ``src/repro/launch/mesh.py:13-19``): NVIDIA's data
    sheet for the H100 SXM5 80 GB HBM3 at its 700 W limit.  These are
    data-sheet peaks, not measurements; no TPU figure remains here."""
    PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 tensor-core FLOP/s
    HBM_BW = 3.35e12                # HBM3 bytes/s
    ICI_BW = 450e9                  # NVLink bytes/s per direction
    HBM_BYTES = 80e9                # HBM bytes


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


# the tag of the point-to-point messages of the collectives inside a
# worker (FSDP's gathers and reductions, the MoE's counts), apart from the
# gossip's, whose tags start at 0
INNER_TAG = 1 << 20

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


def _row_major(coords, sizes) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + int(c) % n
    return r


def _unravel(index: int, sizes) -> list:
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return list(reversed(out))


@dataclasses.dataclass
class WorkerMesh:
    """The ranks of the process group laid out row-major on named axes.
    ``coords`` are this rank's coordinates; ``groups[name]`` is the
    subgroup of the ranks that share every coordinate but ``name``'s with
    this one, and :meth:`group` the same for a set of axes (``None``: the
    whole group; :func:`make_mesh` says which sets are built).  The mesh gives an axis no role: :func:`make_layout`
    says which axes gossip and which split a worker.  ``backend`` is the
    process group's, which decides whether a CUDA payload is staged
    through host buffers (gloo) or handed to the library as it is
    (NCCL)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[object, object] = dataclasses.field(default_factory=dict)
    _host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def world_size(self) -> int:
        return int(math.prod(self.axis_sizes))

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(_unravel(self.rank, self.axis_sizes))

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def _axes(self, axes) -> Tuple[str, ...]:
        """``axes`` in the mesh's order."""
        axes = set(axes)
        return tuple(n for n in self.axis_names if n in axes)

    def size(self, axes) -> int:
        """How many ranks a line over ``axes`` holds."""
        return int(math.prod(self.axis_sizes[self.axis_index(a)]
                             for a in axes))

    def index(self, axes, rank: Optional[int] = None) -> int:
        """The row-major index of ``rank``'s (this one's) coordinates on
        ``axes`` (0 for no axes)."""
        axes = self._axes(axes)
        co = _unravel(self.rank if rank is None else rank, self.axis_sizes)
        return _row_major([co[self.axis_index(a)] for a in axes],
                          [self.axis_sizes[self.axis_index(a)]
                           for a in axes])

    def rank_with(self, axes, index: int, rank: Optional[int] = None) -> int:
        """The rank whose coordinates on ``axes`` are the row-major
        ``index`` and whose others are ``rank``'s (this one's)."""
        axes = self._axes(axes)
        co = _unravel(self.rank if rank is None else rank, self.axis_sizes)
        sizes = [self.axis_sizes[self.axis_index(a)] for a in axes]
        for a, c in zip(axes, _unravel(int(index) % max(
                int(math.prod(sizes)), 1), sizes)):
            co[self.axis_index(a)] = c
        return self.rank_at(co)

    def line(self, axes, rank: Optional[int] = None) -> list:
        """The ranks that share every coordinate off ``axes`` with
        ``rank`` (this one), in row-major order over ``axes``."""
        return [self.rank_with(axes, i, rank)
                for i in range(self.size(self._axes(axes)))]

    def group(self, axes):
        """The subgroup of :meth:`line` (``None``: the whole group; a line
        of one rank has no group and is never reduced over)."""
        axes = self._axes(axes)
        if len(axes) == len(self.axis_names):
            return None
        if not axes:
            raise ValueError("a line over no axis is this rank alone")
        key = axes[0] if len(axes) == 1 else axes
        if key not in self.groups:
            raise ValueError(f"the mesh builds no group over {axes}")
        return self.groups[key]

    def rank_at(self, coords) -> int:
        """The rank at the row-major ``coords``."""
        return _row_major(coords, self.axis_sizes)

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

    def staging(self, key, shape, dtype):
        """A pinned host buffer of ``shape`` that views one flat buffer of
        ``key`` and ``dtype``, grown to the largest request: the
        collectives of many leaf shapes share it, so the host holds the
        largest payload once and not every shape's copy.  Every user
        stages on the rank's one stream and synchronizes it before
        posting, so a buffer is free again by its next use."""
        n = int(math.prod(shape))
        key = tuple(key) + (dtype,)
        buf = self._host.get(key)
        if buf is None or buf.numel() < n:
            self._host.pop(key, None)
            buf = torch.empty(n, dtype=dtype, pin_memory=True)
            self._host[key] = buf
        return buf[:n].view(shape)

    def _sync(self):
        """The staged wire's one deliberate host sync: the copies to the
        pinned buffers must land before gloo reads them.  It is the one
        site exempt from ``torch.cuda.set_sync_debug_mode`` (the round
        contract's checks run rounds under "error"), so the mode is
        switched off around it and restored."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.current_stream(self.device).synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def all_reduce(self, t, group, op=dist.ReduceOp.SUM):
        """In-place ``all_reduce`` of ``t`` over ``group``; on a card under
        gloo through a pinned host buffer (copied in, the stream
        synchronized, reduced, copied back)."""
        if not self.staged:
            dist.all_reduce(t, op=op, group=group)
            return t
        h = self.staging(("reduce",), t.shape, t.dtype)
        h.copy_(t, non_blocking=True)
        self._sync()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h, non_blocking=True)
        return t

    def p2p(self, sends, recvs) -> int:
        """One point-to-point exchange: ``sends`` ``[(tensor, dst, tag)]``
        and ``recvs`` ``[(out, src, tag)]``, posted at once as one
        ``dist.batch_isend_irecv`` and waited for (NCCL pairs a batch's
        sends and receives; posted one by one, two ranks that each
        receive first can wait on each other).  A receive from this rank
        itself (an axis of size 1, an aliased shift) copies the matching
        send.  On a card under gloo each send is copied to a pinned host
        buffer (once for a tensor sent to several peers), the stream
        synchronized, and each receive lands in one and is copied back.
        Returns the bytes handed to ``isend``."""
        me = self.rank
        own = {tag: t for (t, dst, tag) in sends if dst == me}
        for (out, src, tag) in recvs:
            if src == me:
                out.copy_(own[tag])
        sends = [s for s in sends if s[1] != me]
        recvs = [r for r in recvs if r[1] != me]
        if not sends and not recvs:
            return 0
        staged, sent = self.staged, 0
        ops, back, hosted = [], [], {}
        for j, (t, dst, tag) in enumerate(sends):
            if staged:
                h = hosted.get(id(t))
                if h is None:
                    h = hosted[id(t)] = self.staging(("send", j), t.shape,
                                                     t.dtype)
                    h.copy_(t, non_blocking=True)
                t = h
            sent += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, dst, tag=tag))
        for j, (out, src, tag) in enumerate(recvs):
            buf = out
            if staged:
                buf = self.staging(("recv", j), out.shape, out.dtype)
                back.append((out, buf))
            ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
        if staged:
            # the sends' copies have landed, and the last exchange's
            # copies out of the receive buffers too
            self._sync()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for (out, buf) in back:
            out.copy_(buf, non_blocking=True)
        return sent

    def _members(self, group):
        ranks = (list(range(self.world_size)) if group is None
                 else dist.get_process_group_ranks(group))
        return ranks, ranks.index(self.rank)

    def all_gather(self, t, group, dim: int):
        """The ``group``'s tensors shaped as ``t``, concatenated along
        ``dim`` in group-rank order: NCCL's ``all_gather_into_tensor``;
        under gloo each rank sends its ``t`` to every other in one
        :meth:`p2p` batch (gloo's ``all_gather`` moves a third to a
        quarter of the bytes a second that its point to point does)."""
        ranks, i = self._members(group)
        t = t.contiguous()
        if self.backend == "nccl":
            out = t.new_empty((len(ranks) * t.shape[0],) + t.shape[1:])
            dist.all_gather_into_tensor(out, t, group=group)
            return torch.cat(out.chunk(len(ranks)), dim=dim)
        parts = [t if j == i else torch.empty_like(t)
                 for j in range(len(ranks))]
        peers = [(j, r) for j, r in enumerate(ranks) if j != i]
        self.p2p([(t, r, INNER_TAG) for _, r in peers],
                 [(parts[j], r, INNER_TAG) for j, r in peers])
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t, group, dim: int):
        """This rank's slice along ``dim`` (group-rank order) of ``t``
        summed over ``group``: NCCL's ``reduce_scatter_tensor``; under
        gloo each rank sends every other its slice in one :meth:`p2p`
        batch and adds the slices it receives to its own, in group-rank
        order."""
        ranks, i = self._members(group)
        n = t.shape[dim] // len(ranks)
        if self.backend == "nccl":
            parts = torch.cat(t.split(n, dim=dim)).contiguous()
            out = parts.new_empty((parts.shape[0] // len(ranks),)
                                  + parts.shape[1:])
            dist.reduce_scatter_tensor(out, parts, group=group)
            return out
        own = t.narrow(dim, i * n, n)
        got = [torch.empty_like(own) for _ in ranks]
        peers = [(j, r) for j, r in enumerate(ranks) if j != i]
        self.p2p([(t.narrow(dim, j * n, n).contiguous(), r, INNER_TAG)
                  for j, r in peers],
                 [(got[j], r, INNER_TAG) for j, r in peers])
        out = None
        for j in range(len(ranks)):
            part = own if j == i else got[j]
            out = part.clone() if out is None else out + part
        return out


def make_mesh(axis_sizes, axis_names, *, device: torch.device,
              model_axis: int = 1) -> WorkerMesh:
    """The mesh over the initialized process group: the axes
    ``axis_sizes`` on ``axis_names`` and, for ``model_axis > 1``, a
    trailing ``"model"`` axis of that many ranks, with the subgroups of
    every line over one axis built and, where a model axis follows two
    or more named axes, of every line over the named axes (profile A's
    workers) (collective: every rank calls this with the same arguments,
    and builds the groups in one order)."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis sizes {axis_sizes} vs names {axis_names}")
    if MODEL_AXIS in axis_names:
        raise ValueError(f"{MODEL_AXIS!r} is the model axis: pass its size "
                         "as model_axis, not as a named axis")
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
    lines = [(a,) for a in axis_names] if len(axis_names) > 1 else []
    if tp > 1 and len(axis_names) > 2:
        # profile A's workers span every axis but the model one
        lines.append(axis_names[:-1])
    # each line's groups, on every rank, in one order
    for sub in lines:
        others = tuple(a for a in axis_names if a not in sub)
        for flat in range(mesh.size(others)):
            ranks = mesh.line(sub, mesh.rank_with(others, flat, 0))
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[sub[0] if len(sub) == 1 else sub] = g
    if len(axis_names) == 1:
        mesh.groups[axis_names[0]] = None
    return mesh


@dataclasses.dataclass(frozen=True)
class Layout:
    """The reference's ``Layout``: the axes that gossip between workers
    (``worker_axes``) and the roles of the others inside a worker:
    ``tp_axis`` splits its params tensor-parallel, ``fsdp_axis`` splits
    them again and its batch (profile B), ``inner_axis`` splits its batch
    and replicates its params (profile A, ``inner="dp"``).  A worker is
    the line of ranks over the axes off ``worker_axes``.  The serving
    layout has no worker axes, and ``batch_axes`` split its batch."""
    mesh: WorkerMesh
    worker_axes: Tuple[str, ...]
    tp_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    inner_axis: Optional[str] = None
    batch_axes: Tuple[str, ...] = ()    # serving: the axes the batch splits

    @property
    def worker_sizes(self) -> Tuple[int, ...]:
        return tuple(self.mesh.axis_sizes[self.mesh.axis_index(a)]
                     for a in self.worker_axes)

    @property
    def n_workers(self) -> int:
        return int(math.prod(self.worker_sizes)) if self.worker_axes else 1

    @property
    def inner_axes(self) -> Tuple[str, ...]:
        """The axes of one worker's ranks, in the mesh's order."""
        return tuple(a for a in self.mesh.axis_names
                     if a not in self.worker_axes)

    @property
    def worker_ranks(self) -> int:
        """Ranks per worker."""
        return self.mesh.size(self.inner_axes)

    def axis_size(self, name: Optional[str]) -> int:
        return self.mesh.size((name,)) if name else 1

    def axis_coord(self, name: Optional[str]) -> int:
        return self.mesh.index((name,)) if name else 0

    @property
    def batch_axis(self) -> Optional[str]:
        """The axis that splits a worker's batch (FSDP's or the inner
        data-parallel one), or None."""
        return self.fsdp_axis or self.inner_axis

    @property
    def worker_index(self) -> int:
        """This rank's global worker index (row-major over the worker
        axes): which worker's batches it draws."""
        return self.mesh.index(self.worker_axes)

    def inner_index(self, rank: Optional[int] = None) -> int:
        """``rank``'s (this one's) place among its worker's ranks:
        row-major over the inner axes, so (fsdp, tp) under profile B."""
        return self.mesh.index(self.inner_axes, rank)

    def rank_of(self, worker: int, inner: Optional[int] = None) -> int:
        """The rank of ``worker`` at inner place ``inner`` (this rank's by
        default)."""
        r = self.mesh.rank_with(self.worker_axes, worker)
        if inner is None:
            return r
        return self.mesh.rank_with(self.inner_axes, inner, r)

    @property
    def worker_group(self):
        """The ranks that share this one's inner coordinates, one a
        worker (``None``: the whole group)."""
        return self.mesh.group(self.worker_axes)


def make_layout(parallel, mesh: WorkerMesh, *,
                serving: bool = False) -> Layout:
    """The roles of the mesh's axes (``src/repro/launch/sharding.py:
    54-84``).  Profile A: every axis but ``"model"`` gossips; ``"model"``
    is the tensor-parallel axis inside each worker (``inner="tp"``), or
    splits the worker's batch over ranks that each hold its whole params
    (``inner="dp"``), or gossips too (``inner="worker"``).  Profile B:
    ``"pod"`` gossips (without it the mesh is one worker), ``"data"`` is
    the FSDP axis and ``"model"`` the TP axis inside the worker.
    ``serving``: no axis gossips; ``"model"`` is the TP axis, ``"data"``
    the FSDP axis under profile B, and the batch splits over ``"pod"`` and
    ``"data"``."""
    names = tuple(mesh.axis_names)
    has_model = MODEL_AXIS in names
    if serving:
        return Layout(mesh, (),
                      tp_axis=MODEL_AXIS if has_model else None,
                      fsdp_axis=(DATA_AXIS if parallel.profile == "B"
                                 and DATA_AXIS in names else None),
                      batch_axes=tuple(a for a in (POD_AXIS, DATA_AXIS)
                                       if a in names))
    if parallel.profile == "A":
        if parallel.inner not in ("tp", "dp", "worker"):
            raise ValueError(f"inner={parallel.inner!r}: 'tp', 'dp' or "
                             "'worker'")
        if not has_model or parallel.inner == "worker":
            return Layout(mesh, names)
        waxes = tuple(n for n in names if n != MODEL_AXIS)
        if parallel.inner == "dp":
            return Layout(mesh, waxes, inner_axis=MODEL_AXIS)
        return Layout(mesh, waxes, tp_axis=MODEL_AXIS)
    if parallel.profile != "B":
        raise ValueError(f"profile {parallel.profile!r}: 'A' or 'B'")
    extra = [n for n in names if n not in (POD_AXIS, DATA_AXIS, MODEL_AXIS)]
    if extra:
        raise ValueError(
            f"profile 'B' lays a worker per {POD_AXIS!r} coordinate, FSDP "
            f"on {DATA_AXIS!r} and TP on {MODEL_AXIS!r}; the mesh's axes "
            f"{extra} have no role there")
    return Layout(mesh, (POD_AXIS,) if POD_AXIS in names else (),
                  tp_axis=MODEL_AXIS if has_model else None,
                  fsdp_axis=DATA_AXIS if DATA_AXIS in names else None)
