"""The collectives of a rank, recorded as they are posted.

Port of ``src/repro/analysis/hlo_parse.py``.  The reference parses the
collectives out of compiled HLO text; the port runs eagerly, so
:class:`CommRecorder` wraps one :class:`~repro_torch.launch.mesh.
WorkerMesh`'s four collectives (``p2p``, ``all_reduce``, ``all_gather``,
``reduce_scatter``), through which every collective of a round passes:
the gossip's (``ShardedComm._p2p``/``_all_reduce``), the TP and FSDP
groups' (``launch/runtime.py``'s ``axis_group``, ``models/layers.py``)
and the MoE's.  Each call becomes one :class:`CollectiveCall` under the
reference's op names (``collective-permute`` for each send of a P2P batch,
``all-reduce``, ``all-gather``, ``reduce-scatter``) with the reference's
ring-formula wire bytes (:func:`ring_wire_bytes`), so the two packages'
records compare field by field.

The reference multiplies an HLO collective by its loop trips
(``compute_loop_trips``), because an op inside a scan body appears once in
the text.  The recorder counts executed calls, so every ``mult`` is 1 and
the port has no counterpart of that function.

On a meta tensor (the dry run, :mod:`repro_torch.launch.dryrun`) a call
is recorded and nothing is posted: the output takes its shape, and a P2P
batch returns the bytes it would hand to ``isend``.  With ``loopback``
(over a ``fake`` process group, whose collectives move nothing) a call is
recorded and completed locally, as if every rank of the group held this
rank's values, so the round computes on finite, well-formed data (a
received sparse payload's row indices among them).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["CollectiveCall", "CollectiveStats", "CommRecorder",
           "ring_wire_bytes", "summarize"]

OPS = ("collective-permute", "all-reduce", "all-gather", "reduce-scatter")


def ring_wire_bytes(op: str, size: int, n: int) -> float:
    """Effective bytes on the wire per rank of one collective whose result
    is ``size`` bytes over a group of ``n`` (the reference's ring formula,
    ``hlo_parse.py:175-185``)."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * size
    if op == "all-gather":
        return (n - 1) / n * size          # size = the gathered result
    if op == "reduce-scatter":
        return (n - 1) * size              # size = the scattered result
    if op == "all-to-all":
        return (n - 1) / n * size
    return float(size)                      # collective-permute


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One executed collective: the reference's fields (``mult`` is always
    1 here, ``line`` a description of the call), then the port's: the
    payload dtype, the local step it ran in (0 before the first gradient,
    i after the i-th), the calling module and function, whether it ran
    inside a gradient, the mesh axes of its group (empty where the group
    is not one of the mesh's lines) and, for a send, its peer."""
    op: str
    result_bytes: int
    wire_bytes: float
    group: int
    mult: int = 1
    line: str = ""
    dtype: str = ""
    step: int = 0
    site: str = ""
    in_grad: bool = False
    axes: Tuple[str, ...] = ()
    peer: Optional[int] = None


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]     # per rank, summed over the calls
    wire_bytes: Dict[str, float]     # effective ring-formula bytes a rank
    lines: List[str]
    calls: List[CollectiveCall] = dataclasses.field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def summarize(calls) -> CollectiveStats:
    """The reference's per-op sums over ``calls``."""
    counts: Dict[str, int] = {}
    rbytes: Dict[str, int] = {}
    wbytes: Dict[str, float] = {}
    for c in calls:
        counts[c.op] = counts.get(c.op, 0) + c.mult
        rbytes[c.op] = rbytes.get(c.op, 0) + c.result_bytes * c.mult
        wbytes[c.op] = wbytes.get(c.op, 0.0) + c.wire_bytes * c.mult
    return CollectiveStats(counts, rbytes, wbytes,
                           [f"x{c.mult} {c.line}" for c in calls],
                           list(calls))


# frames that only pass a collective on: the site is their caller
_PASS_FILES = ("repro_torch/launch/mesh.py", "repro_torch/analysis/")
_PASS_FUNCS = ("_p2p", "_all_reduce", "exchange", "<lambda>")


def _site() -> str:
    """The port's innermost frame that is not a pass-through, as
    ``module:function`` (``Class.method`` for a method)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        name = f.f_code.co_name
        if ("repro_torch/" in path
                and not any(p in path for p in _PASS_FILES)
                and name not in _PASS_FUNCS):
            mod = f.f_globals.get("__name__", "?")
            qual = getattr(f.f_code, "co_qualname", name)
            return f"{mod.removeprefix('repro_torch.')}:{qual}"
        f = f.f_back
    return "?"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CommRecorder:
    """Record every collective ``mesh`` posts inside a ``with`` block.

    >>> with CommRecorder(mesh) as rec:
    ...     pack.train_round(params, state, batches, 0)
    >>> summarize(rec.calls).wire_bytes["collective-permute"]

    The mesh's four methods are wrapped on the instance and restored on
    exit.  A collective that another runs through (gloo's ``all_gather``
    is one P2P batch) is recorded once, as the outer one.  ``step`` (the
    local step) and ``in_grad`` are set by the caller that times the
    round (:mod:`repro_torch.analysis.round_check`)."""

    def __init__(self, mesh, loopback: bool = False):
        self.mesh = mesh
        self.loopback = loopback
        self.calls: List[CollectiveCall] = []
        self.step = 0
        self.in_grad = False
        self._depth = 0
        self._saved = {}

    # -- bookkeeping --------------------------------------------------------
    def _axes(self, group) -> Tuple[str, ...]:
        if group is None:
            return tuple(self.mesh.axis_names)
        for key, g in self.mesh.groups.items():
            if g is group:
                return (key,) if isinstance(key, str) else tuple(key)
        return ()

    def _group_size(self, group) -> int:
        if group is None:
            return self.mesh.world_size
        import torch.distributed as dist
        return len(dist.get_process_group_ranks(group))

    def _record(self, op, size, n, t, group=None, peer=None, what=""):
        axes = self._axes(group) if op != "collective-permute" else ()
        self.calls.append(CollectiveCall(
            op=op, result_bytes=int(size),
            wire_bytes=ring_wire_bytes(op, int(size), n), group=n,
            line=f"{op} {what}{tuple(t.shape)} {t.dtype} group {n}",
            dtype=str(t.dtype).removeprefix("torch."), step=self.step,
            site=_site(), in_grad=self.in_grad, axes=axes, peer=peer))

    def _outer(self, fn):
        """Run ``fn`` with the nested collectives unrecorded."""
        self._depth += 1
        try:
            return fn()
        finally:
            self._depth -= 1

    # -- the wrapped collectives --------------------------------------------
    # Each one posts through the mesh, or with ``loopback`` (and always on
    # meta tensors) posts nothing and completes as if every rank of the
    # group held this rank's values: a receive gets the send of its tag.
    def _local(self, *tensors) -> bool:
        return self.loopback or any(t.device.type == "meta"
                                    for t in tensors)

    def _p2p(self, sends, recvs):
        mesh = self.mesh
        if self._depth == 0:
            for (t, dst, _tag) in sends:
                if dst != mesh.rank:
                    self._record("collective-permute", _nbytes(t), 2, t,
                                 peer=int(dst), what="send ")
        if not self._local(*[t for (t, _d, _g) in sends],
                           *[o for (o, _s, _g) in recvs]):
            return self._outer(lambda: self._saved["p2p"](sends, recvs))
        by_tag = {tag: t for (t, _d, tag) in sends}
        for (out, _src, tag) in recvs:
            got = by_tag.get(tag)
            if got is not None and got.shape == out.shape:
                out.copy_(got)
            else:
                out.zero_()
        return sum(_nbytes(t) for (t, dst, _g) in sends if dst != mesh.rank)

    def _all_reduce(self, t, group, *args, **kwargs):
        n = self._group_size(group)
        if self._depth == 0:
            self._record("all-reduce", _nbytes(t), n, t, group)
        if self._local(t):
            return t.mul_(n) if t.dtype.is_floating_point else t
        return self._outer(
            lambda: self._saved["all_reduce"](t, group, *args, **kwargs))

    def _all_gather(self, t, group, dim):
        n = self._group_size(group)
        if self._depth == 0:
            self._record("all-gather", n * _nbytes(t), n, t, group)
        if self._local(t):
            import torch
            return torch.cat([t.contiguous()] * n, dim=dim)
        return self._outer(lambda: self._saved["all_gather"](t, group, dim))

    def _reduce_scatter(self, t, group, dim):
        n = self._group_size(group)
        if self._depth == 0:
            self._record("reduce-scatter", _nbytes(t) // n, n, t, group)
        if self._local(t):
            ranks = self._group_ranks(group)
            k = t.shape[dim] // n
            return t.narrow(dim, ranks.index(self.mesh.rank) * k, k) * n
        return self._outer(
            lambda: self._saved["reduce_scatter"](t, group, dim))

    def _group_ranks(self, group):
        if group is None:
            return list(range(self.mesh.world_size))
        import torch.distributed as dist
        return dist.get_process_group_ranks(group)

    # -- context ------------------------------------------------------------
    def __enter__(self):
        for name in ("p2p", "all_reduce", "all_gather", "reduce_scatter"):
            self._saved[name] = getattr(self.mesh, name)
            setattr(self.mesh, name, getattr(self, "_" + name))
        return self

    def __exit__(self, *exc):
        for name in self._saved:
            # the instance attribute goes: the class's method shows again
            delattr(self.mesh, name)
        self._saved = {}
        return False

