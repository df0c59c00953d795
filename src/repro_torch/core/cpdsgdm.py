"""CPD-SGDM — Communication-efficient PD-SGDM (paper Algorithm 2).

Port of ``src/repro/core/cpdsgdm.py:60-661`` on the dense simulation
backend.  The local loop is PD-SGDM's; at a communication round::

    x⁽ᵏ⁾ₜ₊₁ = x⁽ᵏ⁾ₜ₊½ + γ Σⱼ w_kj (x̂⁽ʲ⁾ₜ − x̂⁽ᵏ⁾ₜ)        (line 6, consensus)
    q⁽ᵏ⁾ₜ   = Q(x⁽ᵏ⁾ₜ₊₁ − x̂⁽ᵏ⁾ₜ)                        (line 7, compress)
    send q⁽ᵏ⁾ / recv q⁽ʲ⁾ for j ∈ N_k                    (line 8)
    x̂⁽ʲ⁾ₜ₊₁ = x̂⁽ʲ⁾ₜ + q⁽ʲ⁾                              (line 9, error comp.)

What crosses the wire is the compressor's codec payload
(:mod:`repro_torch.core.wire`): bit-packed signs and scales, packed QSGD
levels and norms, top-k (index, value) slots, rand-k values or sparse
(row index, row) pairs.  Three wire paths, one dispatch, as in the
reference:

* **kernel wire**: the codec has a ``(rows, LANE)`` format and its block
  is the lane, so one pack and one unpack on the flatten-once layout run
  through the CUDA codec kernels (:meth:`CPDSGDM.comm_round_mat` inside
  the kernel round; :meth:`CPDSGDM._comm_kernel_wire` on the tree path);
* **per-leaf codec wire**: any codec, any block, packed and unpacked per
  leaf and per worker (``torch.func.vmap``), with the shared (leaf, round)
  key of rand-k resolved once per leaf, outside ``vmap``;
* **legacy apply** (``packed_wire=False``): Q applied leaf-wise and the f32
  result charged at full precision.

The dense backend keeps one stacked x̂: every worker's copies of its
neighbours' x̂ equal their owners', so the consensus is ``W @ x̂`` — a plain
matrix product, as the reference leaves it to XLA, with round r's W under
a schedule — and the round ships nothing but the payload accounted by
:meth:`CPDSGDM.bytes_per_comm_round` (round r's degree).

Elastic membership: worker s commits its x̂ update (and ships q) in round
r only if s and every copy-holder of s (the workers that receive from it)
are active; a worker that does not commit keeps its x̂ bit for bit, and
its drift rides into its next committed q.  The consensus uses round r's
masked W.  Under churn the kernel round runs the comm on the tree at the
round boundary, where the commit gate lives; a codec with a kernel format
still packs there through the codec kernels (:meth:`_comm_kernel_wire`).

Overlapped rounds (``overlap=True``, the tree path only, as in the
reference): the in-flight payload is the x̂ cut after the previous round's
line 9, and the stale consensus ``γ·gate·(W̃·x̂_buf − x̂_buf)`` is formed at
round start and lands at its end; lines 7-9 stay at the round boundary
(q encodes the round's own drift), commit-gated under membership.

The sharded backend (:class:`~repro_torch.core.gossip.ShardedComm`, one
worker per rank, a static shift graph of one axis): each rank stores x̂ for
itself and a copy for each non-self shift, ``xhat_nbrs["ax{a}_sh{s:+d}"]``,
moved only by the payloads it receives, so every copy keeps the bits of
the x̂ of the worker it tracks (the replica contract).  Line 6 is
``w₀·x̂ + Σ w·x̂_nbrs`` in ``nonself_shifts()`` order, from the stored copies
(on the kernel layout one ``gossip_mix`` launch over the matrices); lines
7-9 ship the codec payload to every neighbour in one P2P batch (the
kernel wire cut to ``used_rows`` by ``rows_wire`` and received into held
zero-tailed buffers; the per-leaf wire's :meth:`WireCodec.wire` entries;
the f32 q without a packed wire), decode it once per source and add it to
that source's copy; the owner adds its own decoded q.  Under membership
round r's liveness is picked on the host: per-receiver coefficients from
the shift entries, dead edges zeroed and their mass on the diagonal, a
non-committing worker's x̂ kept and its payload pruned (its copy-holders
decode zeros to exactly 0).  The sharded backend refuses overlap, the
complete and the hierarchical graphs, schedules and, under membership,
perm graphs, as the reference does (``cpdsgdm.py:79-116``); and a graph
of more than one axis (a torus), where the sum over the per-axis shifts
is not a row of W (ROADMAP C.9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compression import Compressor, SignCompressor
from repro_torch.core.gossip import (CommBackend, ShardedComm,
                                     gossip_bytes_per_round,
                                     refuse_multi_axis, select_round,
                                     worker_mask_like)
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig
from repro_torch.core.topology import exchanges
from repro_torch.core.wire import (leaf_keys, make_codec, pack_tree,
                                  unpack_tree)
from repro_torch.kernels import LANE
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CPDSGDMConfig", "CPDSGDM"]


@dataclasses.dataclass(frozen=True)
class CPDSGDMConfig(PDSGDMConfig):
    gamma: float = 0.4               # consensus step size γ (paper: 0.4/0.5)
    # ship the codec payload (False: apply Q leaf-wise and charge the
    # full-precision f32 result, the reference's debugging baseline)
    packed_wire: bool = True


class CPDSGDM(PDSGDM):
    """Algorithm 2.  Inherits the local momentum step from PD-SGDM."""

    def __init__(self, config: CPDSGDMConfig, comm: CommBackend,
                 compressor: Optional[Compressor] = None):
        if isinstance(comm, ShardedComm):
            self._check_sharded(config, comm)
        super().__init__(config, comm)
        self.compressor = (compressor if compressor is not None
                           else SignCompressor())
        try:
            self.codec = make_codec(self.compressor)
        except TypeError:                # custom operator without a codec
            self.codec = None
        if config.overlap and config.use_kernel:
            raise ValueError(
                "CPD-SGDM overlap=True does not compose with use_kernel: "
                "the delayed consensus + codec wire run on the tree path "
                "(dense simulation only).")
        # elastic membership: the commit mask of every round of the joint
        # cycle, on the host (bytes, the sharded gate) and on the device
        # (the dense x̂ gate)
        self._commit_np = self._commit_t = None
        if comm.membership is not None:
            self._commit_np = np.stack(
                [self._commit_mask(comm.topology_at(r), comm.active_at(r))
                 for r in range(comm.round_cycle)])
            self._commit_t = torch.tensor(self._commit_np,
                                          device=comm.device)

    @staticmethod
    def _check_sharded(config, comm):
        """The reference's refusals on the sharded backend
        (``cpdsgdm.py:79-116``)."""
        if config.overlap:
            raise ValueError(
                "CPD-SGDM overlap=True is dense-only: the xhat_nbrs "
                "error-compensation copies must stay bitwise consistent "
                "with each owner's x̂ (Alg. 2 line 9), and a one-round-"
                "stale consensus breaks that replica contract")
        name = comm.topology.name
        if name == "complete":
            raise ValueError(
                "CPD-SGDM sharded backend needs a shift-structured topology "
                "(ring/torus/exponential); 'complete' has no neighbour state.")
        if name == "hierarchical":
            raise ValueError(
                "CPD-SGDM does not compose with the sharded hierarchical "
                "backend: the xhat_nbrs error-compensation copies track "
                "per-neighbour wires, and the two-level round (exact intra "
                "mean + leader exchange) has no per-edge codec lane.  Use "
                "PD/MT/QG with node_size (optionally with inter_codec), or "
                "run CPD on a flat topology.")
        if comm.period > 1:
            raise ValueError(
                "CPD-SGDM sharded backend requires a static topology: the "
                "xhat_nbrs error-compensation copies track a fixed neighbour "
                "set (Alg. 2 line 9).  Time-varying schedules run on the "
                "dense backend, or use PD-SGDM on the sharded one.")
        if comm.membership is not None and comm.topology.perms:
            raise ValueError(
                "CPD-SGDM sharded elastic membership needs a "
                "shift-structured topology: perm graphs key no per-shift "
                "xhat_nbrs copies to commit-gate.")
        refuse_multi_axis("CPD-SGDM", comm)

    # -- elastic membership: commit masks -------------------------------------
    @staticmethod
    def _commit_mask(top, act) -> np.ndarray:
        """(K,) bool: worker ``s`` commits its error-compensation update in
        a round where only ``act`` workers exchange, i.e. ``s`` and every
        copy-holder of ``s`` (each worker that receives from it) are
        active."""
        act = np.asarray(act, dtype=bool)  # lint: allow
        ok = act.copy()
        for (k, j, _w) in exchanges(top):
            if not act[k]:
                ok[j] = False
        return ok

    def _commit_at(self, r) -> torch.Tensor:
        """(K,) bool commit mask of round ``r`` on the device (``r`` an int
        or a 0-d tensor)."""
        return select_round(self._commit_t, r, "a MembershipSchedule",
                            "_commit_at(r)")

    # -- state ---------------------------------------------------------------
    @staticmethod
    def _key(ax: int, sh: int) -> str:
        return f"ax{ax}_sh{sh:+d}"

    def _shifts(self) -> list:
        """``(key, axis, shift, weight)`` of every non-self shift, in the
        topology's order: the copies of the sharded backend."""
        return [(self._key(ax, sh), ax, sh, w)
                for (ax, sh, w) in self.comm.nonself_shifts()]

    def init(self, params) -> dict:
        state = super().init(params)
        # x̂₀ = x₀: the first round's q then encodes only the local drift
        state["xhat"] = tree_map(
            lambda x: x.detach().to(torch.float32, copy=True), params)
        if self.sharded:
            state["xhat_nbrs"] = {
                key: tree_map(lambda x: x.detach().to(torch.float32,
                                                      copy=True), params)
                for (key, _ax, _sh, _w) in self._shifts()}
        return state

    # -- wire dispatch -------------------------------------------------------
    def _kernel_wire(self) -> bool:
        """Whether the payload comes from the codec kernels on the
        flatten-once layout: the codec has a rows format and its block is
        the kernel lane, so the kernel rows are the per-leaf blocks."""
        return (self.config.packed_wire and self.codec is not None
                and self.codec.rows_supported and self.codec.block == LANE)

    def _payload_wire(self) -> bool:
        """Per-leaf codec wire: codecs without a (matching) kernel format."""
        return self.config.packed_wire and self.codec is not None

    def _apply_Q(self, tree, r):
        """Q leaf-wise and per worker (the ``packed_wire=False`` path)."""
        comp = self.compressor
        keys = (leaf_keys(self.codec, tree, r) if self.codec is not None
                else {name: None for name in tree})
        return {name: torch.func.vmap(
                    lambda x, key=keys[name]: comp.apply(x, key))(leaf)
                for name, leaf in tree.items()}

    # -- communication round (Alg. 2 lines 6-9) --------------------------------
    def comm_round(self, state, params):
        """Alg. 2 lines 6-9.  On the sharded backend under membership,
        round r's liveness is picked on the host (the reference's
        ``_comm_round_masked``, ``cpdsgdm.py:350-415``): the consensus over
        the stored copies with the round's per-receiver coefficients, the
        x̂ update commit-gated and the payloads pruned to committing
        sources."""
        r = self.round_index(state)
        live = self.comm.stored_weights(r) if self.sharded else None
        if live is None:
            return self._comm_round_at(state, params, r)
        diag, edges, _active = live
        return self._comm_round_at(
            state, params, r, diag=diag,
            coeffs={self._key(ax, sh): cv for (ax, sh, cv, _ok) in edges},
            commit=self._commit_np[self.comm.live_round(r, "comm_round")])

    def _stored_consensus(self, xhat, nbrs, diag=None, coeffs=None):
        """Line 6 on the sharded backend, from the stored copies:
        ``w₀·x̂ + Σ w·x̂_nbrs[key]`` left to right in the shifts' order (the
        reference's ``cpdsgdm.py:242-246``); under membership ``diag`` and
        the per-key ``coeffs`` of the round."""
        w0 = float(np.float32(self.comm.self_weight() if diag is None
                              else diag))
        mixhat = tree_map(lambda h: h * w0, xhat)
        for (key, _ax, _sh, w) in self._shifts():
            if coeffs is not None:
                if key not in coeffs:        # a self-aliased shift
                    continue
                w = coeffs[key]
            wf = float(np.float32(w))
            mixhat = tree_map(lambda a, b: a + wf * b, mixhat, nbrs[key])
        return mixhat

    def _comm_round_at(self, state, params, r, *, diag=None, coeffs=None,
                       commit=None):
        gamma = self.config.gamma
        xhat = state["xhat"]
        # line 6: consensus from the stored copies — zero communication
        if self.sharded:
            mixhat = self._stored_consensus(xhat, state["xhat_nbrs"], diag,
                                            coeffs)
        else:
            mixhat = self.comm.mix(xhat, r=r)
        params_new = tree_map(
            lambda x, mh, h: (x.to(torch.float32)
                              + gamma * (mh - h)).to(x.dtype),
            params, mixhat, xhat)
        diff = tree_map(lambda x, h: x.to(torch.float32) - h, params_new,
                        xhat)
        new_state = dict(state)
        self._compress_and_commit(new_state, xhat, diff, r, commit)
        return params_new, new_state

    def _compress_and_commit(self, new_state, xhat, diff, r, commit=None):
        """Lines 7-9 on the drift ``diff``: ``new_state["xhat"]`` = x̂ + Q,
        where a worker that does not commit (under membership) keeps its x̂
        bit for bit; on the sharded backend each neighbour's payload is
        added to its copy (``commit``: the round's (K,) commit mask, the
        sources whose payload ships)."""
        if self._kernel_wire():
            self._comm_kernel_wire(new_state, xhat, diff, commit)
        elif self._payload_wire():
            self._comm_payload_wire(new_state, xhat, diff, r, commit)
        else:
            q = self._apply_Q(diff, r)
            self._commit_self(new_state, xhat, q, commit)
            if self.sharded:
                self._add_to_copies(new_state, self.comm.exchange(
                    q, *self._routes(commit)))
        if self._commit_t is not None and not self.sharded:
            cm = self._commit_at(r)
            new_state["xhat"] = tree_map(
                lambda h_new, h_old: torch.where(
                    worker_mask_like(cm, h_new), h_new, h_old),
                new_state["xhat"], xhat)

    def _commit_self(self, new_state, xhat, q, commit):
        """The owner's line 9: x̂ + q, kept where this rank does not commit
        (``commit`` on the sharded backend)."""
        if commit is not None and not commit[self.comm._coord(0)]:
            new_state["xhat"] = xhat
            return
        new_state["xhat"] = tree_map(lambda h, qq: h + qq.to(torch.float32),
                                     xhat, q)

    def _add_to_copies(self, new_state, decoded):
        """Line 9 on each copy: ``x̂_nbrs[key] += q`` of the shift's
        source (``decoded``: one f32 tree per shift, in their order)."""
        nbrs = dict(new_state["xhat_nbrs"])
        for (key, _ax, _sh, _w), q in zip(self._shifts(), decoded):
            nbrs[key] = tree_map(lambda h, qq: h + qq.to(torch.float32),
                                 nbrs[key], q)
        new_state["xhat_nbrs"] = nbrs

    def _routes(self, commit=None) -> tuple:
        """The exchange of every copy's source, ``(axis, "shift", shift)``,
        and with ``commit`` (under membership) the sources that ship, per
        shift."""
        routes = [(ax, "shift", sh) for (_k, ax, sh, _w) in self._shifts()]
        return routes, (None if commit is None else [commit] * len(routes))

    def _exchange_rows(self, payload, plan, commit=None) -> list:
        """The kernel-wire payload (trimmed by ``rows_wire``) to every
        neighbour and theirs back in one P2P batch, into the held buffers:
        per shift the received payload at full extent, ready to unpack
        (``rows_unwire`` without an allocation)."""
        routes, ok = self._routes(commit)
        wire = self.codec.rows_wire(payload, plan)
        full, land = self._wire_buffers(payload, wire, routes)
        self.comm.exchange(wire, routes, out=land, source_ok=ok)
        return full

    # -- overlapped rounds (tree path) -------------------------------------------
    # x̂ moves only at round boundaries, so the stale consensus lands the
    # same consensus mass as line 6, issued at round start; under membership
    # its mask is the delivery round's.
    def overlap_begin(self, state) -> dict:
        mix = state["mix"]
        gate = (mix["phase"] > 0).to(torch.float32)
        gamma = self.config.gamma
        mixed = self.comm.stale_mix(mix["buf"], r=self.round_index(state))
        return {"dx": tree_map(lambda mh, h: gamma * (mh - h) * gate, mixed,
                               mix["buf"])}

    def overlap_apply(self, state, params, delta):
        """Land the stale consensus, then lines 7-9 on the landed params
        (commit-gated under membership) and cut the next payload, x̂."""
        r = self.round_index(state)
        xhat = state["xhat"]
        params_new = tree_map(lambda x, d: (x.to(torch.float32) + d)
                              .to(x.dtype), params, delta["dx"])
        diff = tree_map(lambda x, h: x.to(torch.float32) - h, params_new,
                        xhat)
        new_state = dict(state)
        self._compress_and_commit(new_state, xhat, diff, r)
        new_state["mix"] = self._snapshot_mix(new_state, params_new)
        return params_new, new_state

    def _snapshot_mix(self, state, params) -> dict:
        # the payload is x̂ after line 9: line 6's consensus mixes x̂
        return {"buf": state["xhat"],
                "phase": torch.ones((), dtype=torch.int32,
                                    device=state["step"].device)}

    def _comm_kernel_wire(self, new_state, xhat, diff, commit=None):
        """Lines 7-9 on the flatten-once layout from the tree path: one
        codec pack of the (stacked) drift matrix and one unpack; on the
        sharded backend the payload to the neighbours and one unpack per
        source."""
        plan = kops.KernelPlan.for_tree(diff, worker_dim=True)
        mat = plan.flatten(diff)
        payload = self.codec.rows_pack(mat, counts=self.row_counts(plan, mat),
                                       plan=plan)
        del mat
        q_self = plan.unflatten(self.codec.rows_unpack(payload, plan=plan),
                                dtype=torch.float32)
        self._commit_self(new_state, xhat, q_self, commit)
        if self.sharded:
            got = self._exchange_rows(payload, plan, commit)
            self._add_to_copies(new_state, [
                plan.unflatten(self.codec.rows_unpack(g, plan=plan),
                               dtype=torch.float32) for g in got])

    def _comm_payload_wire(self, new_state, xhat, diff, r, commit=None):
        """Lines 7-9 with per-leaf codec payloads, packed and unpacked per
        worker (the dense backend simulates the exchange; the sharded one
        ships each payload's :meth:`WireCodec.wire` entries, rand-k's
        values without their indices)."""
        codec = self.codec
        keys = leaf_keys(codec, diff, r)
        payloads = pack_tree(codec, diff, keys)
        q = unpack_tree(codec, payloads, diff, keys)
        self._commit_self(new_state, xhat, q, commit)
        if self.sharded:
            got = self.comm.receive_payloads(
                {n: codec.wire(p) for n, p in payloads.items()},
                *self._routes(commit))
            self._add_to_copies(new_state, [
                unpack_tree(codec, g, diff, keys) for g in got])

    # -- kernel round (flatten-once matrix domain) ------------------------------
    @property
    def kernel_comm_supported(self) -> bool:
        """Matrix-domain comm needs the kernel wire format and no
        membership schedule; other codecs (a sign block other than the
        lane, say) and every codec under churn fall back to the tree comm
        at the round boundary, where the commit gate lives."""
        return self._kernel_wire() and self.comm.membership is None

    def mat_state(self, plan, state) -> dict:
        mats = super().mat_state(plan, state)
        if self.kernel_comm_supported:
            mats["xhat"] = plan.flatten(state["xhat"])
            if self.sharded:
                mats["xhat_nbrs"] = {k: plan.flatten(v) for k, v in
                                     state["xhat_nbrs"].items()}
        return mats

    def unmat_state(self, plan, mats, state, step) -> dict:
        new_state = super().unmat_state(plan, mats, state, step)
        if "xhat" in mats:
            new_state["xhat"] = plan.unflatten(mats["xhat"],
                                               dtype=torch.float32)
        if "xhat_nbrs" in mats:
            new_state["xhat_nbrs"] = {
                k: plan.unflatten(v, dtype=torch.float32)
                for k, v in mats["xhat_nbrs"].items()}
        return new_state

    def comm_round_mat(self, x_mat, mats, counts, r, *, plan=None):
        """Alg. 2 lines 6-9 on the kernel layout: the consensus (``W @ x̂``,
        a matmul, on the dense backend; one ``gossip_mix`` launch over the
        stored copies on the sharded one), the drift, one codec pack and
        one unpack (and one per source on the sharded backend); ``counts``
        are the device row counts tiled over the workers (the sparse codec
        reads each gathered row's count at its own worker's row)."""
        if plan is None:
            raise ValueError("CPD-SGDM matrix comm needs the KernelPlan")
        if self.sharded:
            return self._sharded_round_mat(x_mat, mats, counts, plan)
        gamma = self.config.gamma
        xhat = mats["xhat"]
        mixhat = self.comm.mix(xhat, r=r)
        x_new = x_mat + gamma * (mixhat - xhat)
        payload = self.codec.rows_pack(x_new - xhat, counts=counts, plan=plan)
        new_mats = dict(mats)
        new_mats["xhat"] = xhat + self.codec.rows_unpack(payload, plan=plan)
        return x_new, new_mats

    def _sharded_round_mat(self, x_mat, mats, counts, plan):
        """The sharded round on the round's own matrices (the reference's
        ``comm_round_mat``, ``cpdsgdm.py:583-624``), written in place: the
        consensus ``w₀·x̂ + Σ w·x̂_nbrs`` in one ``gossip_mix`` launch, then
        ``x + γ(mix − x̂)``, one pack of the drift, the payload to every
        neighbour in one P2P batch, ``x̂ += unpack(own)`` and each copy
        ``+= unpack(its source's)``."""
        shifts = self._shifts()
        xhat, nbrs = mats["xhat"], mats["xhat_nbrs"]
        d = kops.gossip_mix_mat(
            (xhat,) + tuple(nbrs[key] for (key, _a, _s, _w) in shifts),
            (self.comm.self_weight(),) + tuple(w for (_k, _a, _s, w)
                                               in shifts))
        d.sub_(xhat).mul_(self.config.gamma)
        x_new = x_mat.add_(d)
        payload = self.codec.rows_pack(torch.sub(x_new, xhat, out=d),
                                       counts=counts, plan=plan)
        del d
        xhat.add_(self.codec.rows_unpack(payload, plan=plan))
        for (key, _a, _s, _w), got in zip(
                shifts, self._exchange_rows(payload, plan)):
            nbrs[key].add_(self.codec.rows_unpack(got, plan=plan))
        return x_new, mats

    # -- comm-cost model ---------------------------------------------------------
    def bytes_per_comm_round(self, params, r: int = 0) -> int:
        """Per-worker wire bytes of communication round ``r``; ``params`` is
        one worker's tree.  Codec wire: per leaf the codec's exact payload
        (padding blocks included, they really ship), × the degree.
        ``packed_wire=False`` ships the full-precision f32 q.  Under
        membership only committing workers ship, each to all its
        copy-holders: × committers / K (a float where that is not 1)."""
        frac = 1.0
        if self._commit_np is not None:
            cm = self._commit_np[r % self._commit_np.shape[0]]
            frac = float(cm.sum()) / cm.shape[0]
        sizes = [int(np.prod(tuple(l.shape), dtype=np.int64))
                 for l in tree_leaves(params)]
        if self.config.packed_wire and self.codec is not None:
            payload = sum(self.codec.wire_bytes(n) for n in sizes)
            base = self.comm.topology_at(r).degree * payload
            return base if frac == 1.0 else base * frac
        bits = (32.0 if self.codec is not None
                else self.compressor.wire_bits_per_element(
                    tree_leaves(params)[0].dtype))
        if self._commit_np is not None:
            base = self.comm.topology_at(r).degree * sum(sizes) * bits / 8.0
            return int(base) if frac == 1.0 else float(base * frac)
        return gossip_bytes_per_round(params, self.comm,
                                      bits_per_element=bits, r=r)
