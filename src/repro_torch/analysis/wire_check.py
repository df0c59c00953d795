"""Round-contract checks on a sharded round's launches and collectives.

Port of ``src/repro/analysis/hlo_check.py``.  The reference reads the
compiled round's HLO; the port reads one executed round: the momentum
launches (:func:`watch_momentum`) and the collectives that
:class:`~repro_torch.analysis.collectives.CommRecorder` recorded.

* **in place** (the counterpart of ``check_donation``): on the paths whose
  momentum launch runs in place (PD-SGDM, C-SGDM and CPD-SGDM on the
  kernel layout), each launch returns its own x and m;
* **collective allowlist**: the gossip's sends, all-reduces of at most
  :data:`SCALAR_ALLREDUCE_BYTES`, a hierarchical round's node-group
  all-reduces, and inside the gradient the TP and FSDP groups'
  collectives over the worker's inner axes; anything else is a violation
  (the reference checked a model axis of 1 only);
* **accounted ≡ shipped**: the sends' bytes a rank a round equal
  ``opt.bytes_per_comm_round`` of the rank's tree, and on a two-level
  round ``hier_bytes_per_level``'s levels.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional

__all__ = ["SCALAR_ALLREDUCE_BYTES", "check_collectives_allowed",
           "check_hier_wire_bytes", "check_in_place", "check_sharded_round",
           "check_wire_bytes", "watch_momentum"]

# an all-reduce at or below this payload is bookkeeping (a scalar loss),
# not gossip traffic
SCALAR_ALLREDUCE_BYTES = 256


def _same_bytes(a, b) -> bool:
    """Whether ``a`` and ``b`` are the same bytes: their data pointers on a
    device, their storage and offset on meta (where every pointer is 0)."""
    if a.device.type == "meta":
        return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
                and a.storage_offset() == b.storage_offset())
    return a.data_ptr() == b.data_ptr()


@contextlib.contextmanager
def watch_momentum(launches: list):
    """Record each ``kops.momentum_update_mat`` call of the block in
    ``launches`` as ``(in place?, x is x', m is m')``."""
    from repro_torch.kernels import ops as kops
    inner = kops.momentum_update_mat

    def wrapped(x_mat, m_mat, g_mat, **kw):
        out = inner(x_mat, m_mat, g_mat, **kw)
        launches.append((bool(kw.get("inplace")), _same_bytes(out[0], x_mat),
                         _same_bytes(out[1], m_mat)))
        return out
    kops.momentum_update_mat = wrapped
    try:
        yield launches
    finally:
        kops.momentum_update_mat = inner


def check_in_place(launches: list, *, expected: Optional[int] = None
                   ) -> List[str]:
    """Every momentum launch of the round wrote over its own x and m (the
    counterpart of ``check_donation``: the round holds no copy of x' and
    m' beside x and m).  ``expected``: the launches a round."""
    out = []
    if expected is not None and len(launches) != expected:
        out.append(f"expected {expected} momentum launch(es) a round, found "
                   f"{len(launches)}")
    for i, (inplace, same_x, same_m) in enumerate(launches):
        if not (inplace and same_x and same_m):
            out.append(f"momentum launch {i} out of place: x' is x {same_x},"
                       f" m' is m {same_m} (inplace={inplace}); the round "
                       "holds a copy of the params beside them")
    return out


def check_collectives_allowed(
        calls: Iterable, node_allreduce_group: Optional[int] = None,
        inner_axes: Iterable[str] = ()) -> List[str]:
    """No collective beyond the expected set: the gossip's
    ``collective-permute`` sends; an ``all-reduce`` of at most
    :data:`SCALAR_ALLREDUCE_BYTES`; with ``node_allreduce_group`` an
    all-reduce over a group of exactly that many ranks (the in-node mean
    and rebroadcast); and inside the gradient any collective over the
    worker's ``inner_axes`` (its TP or FSDP ranks).  Everything else (a
    collective over the worker axis above all) is a violation."""
    inner = set(inner_axes)
    out = []
    for c in calls:
        if c.op == "collective-permute":
            continue
        if c.op == "all-reduce" and (
                c.result_bytes <= SCALAR_ALLREDUCE_BYTES
                or c.group == node_allreduce_group):
            continue
        if c.in_grad and c.axes and set(c.axes) <= inner:
            continue
        out.append(f"unexpected collective in the round: {c.op} "
                   f"({c.result_bytes} B payload, group {c.group}"
                   + (f" over {'×'.join(c.axes)}" if c.axes else "")
                   + f", {'inside' if c.in_grad else 'outside'} the "
                   f"gradient) at {c.site}")
    return out


def _sent(calls) -> int:
    return int(sum(c.wire_bytes for c in calls
                   if c.op == "collective-permute"))


def check_wire_bytes(calls, expected: int) -> List[str]:
    """The bytes a rank hands to ``isend`` a round ≡
    ``bytes_per_comm_round`` of its tree (the rank's shards where a worker
    spans several ranks: each rank ships its own)."""
    got = _sent(calls)
    if got != int(expected):
        return [f"wire bytes: the round ships {got} B a rank but "
                f"bytes_per_comm_round accounts {int(expected)} B"]
    return []


def check_hier_wire_bytes(calls, levels: dict, *,
                          node_size: int) -> List[str]:
    """Per-level accounted ≡ shipped on a two-level round, from a node
    leader's view (rank 0 leads node 0): its sends equal
    ``levels["inter_site"]``, and the ring wire bytes of its node-group
    all-reduces ``levels["intra_wire"]`` (the kernel layout's too: its
    levels are cut to the plan's used rows, as the accounting is)."""
    out = []
    got = _sent(calls)
    if got != int(levels["inter_site"]):
        out.append(f"hier inter wire: the round ships {got} B of "
                   "collective-permute but the level accounting expects "
                   f"{int(levels['inter_site'])} B")
    ar = sum(c.wire_bytes for c in calls
             if c.op == "all-reduce" and c.group == int(node_size)
             and not c.in_grad)
    if abs(ar - float(levels["intra_wire"])) > 1.0:
        out.append(f"hier intra wire: the round ships {ar:.0f} B of "
                   "node-group all-reduce but the level accounting expects "
                   f"{float(levels['intra_wire']):.0f} B")
    return out


def in_place_family(opt) -> bool:
    """Whether ``opt``'s kernel round launches the momentum in place
    (PD-SGDM, C-SGDM and CPD-SGDM; MT's and QG's inputs stay untouched)."""
    from repro_torch.core import CPDSGDM, CSGDM, PDSGDM
    return type(opt) in (PDSGDM, CSGDM, CPDSGDM) and opt.config.use_kernel


def check_sharded_round(pack, calls, launches: Optional[list] = None, *,
                        check_bytes: bool = True) -> List[str]:
    """The launch and collective checks on one executed round of a built
    ``TrainPack`` (``calls``: its recorded collectives, ``launches``: its
    momentum launches): in place, the allowlist, accounted ≡ shipped
    (``check_bytes``: the round's graph is round 0's)."""
    from repro_torch.launch.runtime import per_worker
    opt = pack.opt
    out = []
    if launches is not None and in_place_family(opt):
        out += check_in_place(launches, expected=opt.config.p)
    top = opt.comm.topology_at(0)
    inner = pack.layout.inner_axes
    hier = (top.name == "hierarchical"
            and getattr(opt.comm, "membership", None) is None)
    rank_tree = per_worker(pack.params_struct)
    if hier:
        node_size = int(top.axis_sizes[1])
        out += check_collectives_allowed(
            calls, node_allreduce_group=node_size, inner_axes=inner)
        if check_bytes:
            out += check_hier_wire_bytes(
                calls, opt.hier_bytes_per_level(rank_tree),
                node_size=node_size)
        return out
    out += check_collectives_allowed(calls, inner_axes=inner)
    if check_bytes:
        out += check_wire_bytes(calls, opt.bytes_per_comm_round(rank_tree))
    return out
