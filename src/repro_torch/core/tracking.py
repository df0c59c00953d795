"""MT-DSGDm and QG-DSGDm: momentum variants for non-IID workloads.

Port of ``src/repro/core/tracking.py:84-654`` on the dense simulation
backend and on the sharded backends.  Both keep PD-SGDM's periodic
structure (p local steps, one gossip) and its fused round, on the tree
and on the flatten-once kernel layout.

* **MT-DSGDm** (Momentum Tracking, periodic form).  Each worker carries a
  tracking correction ``c`` and feeds it, not its raw gradient, into the
  momentum recursion; a round gossips ``(x, c)``::

      ĝ = ∇F(x; ξ) + λx;   c ← c + ĝ − ĝ_prev;   m ← μm + c;   x ← x − ηm
      at a round:  x ← Σⱼ w_kj xⱼ;   c ← Σⱼ w_kj Q(cⱼ)

  With ``c₀ = ĝ₋₁ = 0``, mean_k c = mean_k ĝ after every step and every
  (doubly stochastic) mix.  ``Q`` is an optional wire codec for the
  correction (compressed tracking); every worker mixes the quantized
  corrections, its own included.  On the kernel layout a local step is
  three launches: ``gossip_mix`` for ĝ = 1·g + λ·x (skipped at λ = 0),
  ``gossip_mix`` for c + ĝ − ĝ_prev, and one ``momentum_update`` at
  weight decay 0 on c; a round gossips x and c (or packs c with the
  codec's rows kernels, unpacks it and gossips the decoded matrix).
* **QG-DSGDm** (quasi-global momentum, periodic form).  The buffer is
  frozen within a round and moves once per gossip, from the mixed round
  displacement::

      x ← x − η(ĝ + μm)                                (m frozen)
      at a round:  x ← Σⱼ w_kj xⱼ;   m ← μm + (1−μ)(x_prev − x)/(ηp);
                   x_prev ← x

  The kernel round runs the momentum kernel, whose x update is exactly
  x − η(μm + ĝ), and discards its m; the buffer update is plain elementwise
  torch, as the reference leaves it to XLA.  One tensor on the wire.

Elastic membership: both mix with round r's masked W.  A straggler's
masked row is ``e_k``, so MT's compressed tracking keeps its raw c, not
its own Q(c), and the round runs on the tree at the boundary; QG's
straggler folds its own round displacement into m, and needs no code.
Bytes: the correction wire × the round's active edges per worker.

Overlapped rounds (``overlap=True``): MT forms the stale tracking delta
``dc = gate·(W̃·c_buf − c_buf)`` beside ``dx`` at round start and drips
``dc/p`` into c after every local step (on the kernel layout, the gossip
kernel with weights (1, 1/p)), so c is refreshed within the round
instead of aging; a codec on the correction refuses overlap, as in the
reference.  QG lands the stale correction, then folds the realized round
displacement into its buffer as in the synchronous form.  On a
hierarchical graph MT's bytes double at every level (the ``(x, c)``
pair).

MT's compressed tracking on the sharded backend
(:class:`~repro_torch.core.gossip.ShardedComm`, a static shift graph of
one axis; the reference's ``_mix_c_sharded``, ``tracking.py:251-337``): each
rank quantizes its own c, ships the codec payload to every neighbour and
mixes the decoded corrections, ``w₀·Q(c) + Σ w·unpack(recv)`` (the self
term quantized too, so the sharded and the dense rounds agree).  On the
kernel layout one pack, one unpack per source and the owner's, the sum in
one ``gossip_mix`` launch, and the payload (cut to ``used_rows``, received
into held zero-tailed buffers) rides in the P2P batch of x's wire; on the
tree the per-leaf payloads of every leaf go in one batch of their own.
Under membership round r's liveness is picked on the host: an edge ships
only if both its ends are active, its receiver's coefficient is the
shift's weight (0 on a dead edge, the lost mass on the diagonal), and a
straggler keeps its raw c.  The sharded backend refuses compressed
tracking on a hierarchical or complete graph and on a schedule, as the
reference does (``tracking.py:111-133``), and on a graph of more than one
axis, where the sum over the per-axis shifts is not a row of W (ROADMAP
C.9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compression import Compressor
from repro_torch.core.gossip import (CommBackend, ShardedComm,
                                     gossip_bytes_per_round,
                                     refuse_multi_axis, worker_mask_like)
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig
from repro_torch.core.wire import (leaf_keys, make_codec, pack_tree,
                                  round_trip_tree, unpack_tree)
from repro_torch.kernels import LANE
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["MTDSGDMConfig", "MTDSGDm", "QGDSGDMConfig", "QGDSGDm"]


def _zeros_f32(tree):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


@dataclasses.dataclass(frozen=True)
class MTDSGDMConfig(PDSGDMConfig):
    """MT-DSGDm shares PD-SGDM's knobs; the tracking wire is shaped by the
    compressor handed to the optimizer (None = full-precision c)."""


@dataclasses.dataclass(frozen=True)
class QGDSGDMConfig(PDSGDMConfig):
    """QG-DSGDm shares PD-SGDM's knobs (``nesterov`` is rejected: the
    buffer is not a gradient accumulator, there is nothing to look ahead
    along)."""


class MTDSGDm(PDSGDM):
    """Momentum Tracking, periodic form.  Gossips ``(x, c)`` pairs."""

    def __init__(self, config: MTDSGDMConfig, comm: CommBackend,
                 compressor: Optional[Compressor] = None):
        codec = make_codec(compressor) if compressor is not None else None
        if codec is not None and config.overlap:
            raise ValueError(
                "MT-DSGDm compressed tracking does not compose with "
                "overlap=True: the in-flight correction payload would need "
                "a second codec wire per round")
        if codec is not None and isinstance(comm, ShardedComm):
            if comm.topology.name == "hierarchical":
                raise ValueError(
                    "MT-DSGDm compressed tracking does not compose with the "
                    "sharded hierarchical backend: the correction wire would "
                    "need its own codec lane through the two-level round.  "
                    "Use the hierarchical inter_codec for x compression, or "
                    "run compressed tracking on a flat topology.")
            if comm.topology.name == "complete":
                raise ValueError(
                    "MT-DSGDm compressed tracking on the sharded backend "
                    "needs a shift-structured topology (ring/torus/"
                    "exponential); 'complete' has no per-neighbour wire.")
            if comm.period > 1:
                raise ValueError(
                    "MT-DSGDm compressed tracking requires a static "
                    "topology on the sharded backend: the correction "
                    "payload is exchanged per fixed neighbour.  Time-"
                    "varying schedules run compressed tracking on the "
                    "dense backend, or drop the compressor (full-precision "
                    "c composes with schedules on both backends).")
            refuse_multi_axis("MT-DSGDm compressed tracking", comm)
        super().__init__(config, comm)
        self.compressor = compressor
        self.codec = codec

    # -- state ---------------------------------------------------------------
    def init(self, params) -> dict:
        state = super().init(params)
        # c₀ = ĝ₋₁ = 0: the first local step sets c = ĝ₀
        state["c"] = _zeros_f32(params)
        state["g_prev"] = _zeros_f32(params)
        return state

    # -- local step (tracking + momentum) -------------------------------------
    def local_step(self, state, params, grads):
        """ĝ = g + λx, c ← c + ĝ − ĝ_prev, then the momentum step on c,
        each op rounded as the kernel round rounds it."""
        cfg = self.config
        lr = cfg.lr(state["step"])
        g32 = tree_map(lambda g, x: g.to(torch.float32)
                       + cfg.weight_decay * x.to(torch.float32),
                       grads, params)
        c_new = tree_map(lambda c, g, gp: c + g - gp,
                         state["c"], g32, state["g_prev"])

        def upd(x, m, c):
            x32 = x.to(torch.float32)
            m_new = cfg.mu * m + c
            d = (c + cfg.mu * m_new) if cfg.nesterov else m_new
            return (x32 - lr * d).to(x.dtype), m_new

        pairs = tree_map(upd, params, state["m"], c_new)
        new_state = dict(state)
        new_state["m"] = {k: m for k, (_, m) in pairs.items()}
        new_state["c"] = c_new
        new_state["g_prev"] = g32
        new_state["step"] = state["step"] + 1
        return {k: x for k, (x, _) in pairs.items()}, new_state

    # -- overlapped rounds: staleness-refreshed tracking ------------------------
    # c is re-synchronized only at round boundaries, so late in a long round
    # every worker descends along a correction up to p steps old.  Under
    # overlap the stale delta dc = W̃·c̃ − c̃, formed at round start, is
    # dripped into c as dc/p after every local step; under a
    # doubly-stochastic W̃ mean_k(dc) = 0, so each drip keeps the tracking
    # invariant.
    overlap_delta_keys: tuple = ("dx", "dc")
    overlap_refreshes: bool = True

    def _delayed_mix_init(self, params) -> dict:
        mix = super()._delayed_mix_init(params)
        mix["buf_c"] = _zeros_f32(params)     # c₀ = 0: the first payload too
        return mix

    def overlap_begin(self, state) -> dict:
        delta = super().overlap_begin(state)
        mix = state["mix"]
        gate = (mix["phase"] > 0).to(torch.float32)
        mixed_c = self.comm.stale_mix(mix["buf_c"], r=self.round_index(state))
        delta["dc"] = tree_map(lambda mc, c: (mc - c) * gate, mixed_c,
                               mix["buf_c"])
        return delta

    def overlap_step_refresh(self, state, delta):
        inv_p = float(np.float32(1.0 / self.config.p))
        new_state = dict(state)
        new_state["c"] = tree_map(lambda c, d: c + inv_p * d, state["c"],
                                  delta["dc"])
        return new_state

    def _snapshot_mix(self, state, params) -> dict:
        mix = super()._snapshot_mix(state, params)
        mix["buf_c"] = state["c"]
        return mix

    # -- communication: gossip (x, c) ------------------------------------------
    def comm_round(self, state, params):
        r = self.round_index(state)
        new_state = dict(state)
        if self.codec is not None and self.sharded:
            new_state["c"] = self._mix_c_sharded(state["c"], r)
            return self.comm.mix(params, r=r), new_state
        c = state["c"]
        if self.codec is not None:
            # Q(c) per leaf and worker, with the shared (leaf, round) keys
            c = round_trip_tree(self.codec, c, r)
        new_state["c"] = self.comm.mix(c, r=r)
        am = self.comm.active_mask(r) if self.codec is not None else None
        if am is not None:
            # a straggler's masked row is e_k, which would quantize its c
            # in place with no exchange: it keeps the raw c
            new_state["c"] = tree_map(
                lambda mc, cc: torch.where(worker_mask_like(am, mc), mc, cc),
                new_state["c"], state["c"])
        return self.comm.mix(params, r=r), new_state

    def _mix_c_sharded(self, c, r):
        """The compressed correction mix on the sharded backend, per leaf
        (the reference's ``_mix_c_sharded`` and ``_mix_c_sharded_masked``,
        ``tracking.py:251-337``): ``w₀·Q(c) + Σ w·unpack(recv)`` in the
        shifts' order, every leaf's payload to every neighbour in one P2P
        batch.  Under membership round r's liveness, picked on the host:
        an edge ships only if both its ends are active, the coefficients
        and the diagonal are :meth:`ShardedComm.stored_weights`', and a
        worker that is not active keeps its raw c."""
        comm, codec = self.comm, self.codec
        edges = [(ax, sh, w, None) for (ax, sh, w) in comm.nonself_shifts()]
        diag, active = comm.self_weight(), True
        live = comm.stored_weights(r)
        if live is not None:
            diag, edges, active = live
        keys = leaf_keys(codec, c, r)
        payloads = pack_tree(codec, c, keys)
        w0 = float(np.float32(diag))
        mixed = {name: w0 * q for name, q in
                 unpack_tree(codec, payloads, c, keys).items()}
        got = comm.receive_payloads(
            {n: codec.wire(p) for n, p in payloads.items()},
            [(ax, "shift", sh) for (ax, sh, _w, _ok) in edges],
            [ok for (_ax, _sh, _w, ok) in edges])
        for (_ax, _sh, w, _ok), recv in zip(edges, got):
            wf = float(np.float32(w))
            for name, q in unpack_tree(codec, recv, c, keys).items():
                mixed[name] = mixed[name] + wf * q
        return mixed if active else c

    # -- kernel round (flatten-once matrix domain) ------------------------------
    def _kernel_wire(self) -> bool:
        return (self.codec is not None and self.codec.rows_supported
                and self.codec.block == LANE)

    @property
    def kernel_comm_supported(self) -> bool:
        """Full-precision c mixes like x; compressed tracking needs the
        codec's rows format at the lane block, and no membership (a
        rand-k or sign-64 wire, or any codec under churn, falls back to
        the tree comm at the round boundary, where the straggler pin
        lives)."""
        return self.codec is None or (self._kernel_wire()
                                      and self.comm.membership is None)

    def mat_state(self, plan, state) -> dict:
        mats = super().mat_state(plan, state)
        mats["c"] = plan.flatten(state["c"])
        mats["g_prev"] = plan.flatten(state["g_prev"])
        if self.config.overlap:
            mats["mix_buf_c"] = plan.flatten(state["mix"]["buf_c"])
        return mats

    def unmat_state(self, plan, mats, state, step) -> dict:
        new_state = super().unmat_state(plan, mats, state, step)
        new_state["c"] = plan.unflatten(mats["c"], dtype=torch.float32)
        new_state["g_prev"] = plan.unflatten(mats["g_prev"],
                                             dtype=torch.float32)
        if self.config.overlap:
            new_state["mix"] = {
                **new_state["mix"],
                "buf_c": plan.unflatten(mats["mix_buf_c"],
                                        dtype=torch.float32)}
        return new_state

    def overlap_begin_mat(self, mats, r, gate, *, plan=None) -> dict:
        delta = super().overlap_begin_mat(mats, r, gate, plan=plan)
        buf_c = mats["mix_buf_c"]
        delta["dc"] = (self._stale_gossip_mat(buf_c, r, plan=plan) - buf_c) \
            * gate
        return delta

    def overlap_refresh_mat(self, mats, delta):
        """The drip: c + (1/p)·dc, one gossip launch with static weights."""
        return {**mats, "c": kops.gossip_mix_mat(
            (mats["c"], delta["dc"]), (1.0, 1.0 / self.config.p))}

    def overlap_apply_mat(self, x_mat, mats, delta, r):
        x_new, mats = super().overlap_apply_mat(x_mat, mats, delta, r)
        return x_new, {**mats, "mix_buf_c": mats["c"]}

    def local_step_mat(self, x_mat, mats, g, step):
        """The tracking update as two fused AXPYs, then the momentum
        kernel on c."""
        cfg = self.config
        g_mat = kops.as_matrix(g)
        g32 = (kops.gossip_mix_mat((g_mat, x_mat), (1.0, cfg.weight_decay))
               if cfg.weight_decay else g_mat)
        c_new = kops.gossip_mix_mat((mats["c"], g32, mats["g_prev"]),
                                    (1.0, 1.0, -1.0))
        x_new, m_new = kops.momentum_update_mat(
            x_mat, mats["m"], c_new, mu=cfg.mu, lr=cfg.lr(step),
            weight_decay=0.0, nesterov=cfg.nesterov)
        return x_new, {**mats, "m": m_new, "c": c_new, "g_prev": g32}

    def comm_round_mat(self, x_mat, mats, counts, r, *, plan=None):
        """Dual gossip on the kernel layout: x and c mix matrix to matrix;
        compressed tracking packs c with the codec's rows kernels, unpacks
        it and mixes the decoded matrix (the self term quantized too).  On
        the sharded backend each source's payload is decoded and the sum
        ``w₀·Q(c) + Σ w·unpack(recv)`` is one ``gossip_mix`` launch; the
        payload rides in the P2P batch of x's wire."""
        if self.codec is None:
            return (self._gossip_mat(x_mat, r, plan=plan),
                    {**mats, "c": self._gossip_mat(mats["c"], r, plan=plan)})
        payload = self.codec.rows_pack(mats["c"], counts=counts, plan=plan)
        q_self = self.codec.rows_unpack(payload, plan=plan)
        if not self.sharded:
            return (self._gossip_mat(x_mat, r, plan=plan),
                    {**mats, "c": self._gossip_mat(q_self, r)})
        if plan is None:
            raise ValueError("MT-DSGDm matrix comm needs the KernelPlan")
        comm = self.comm
        nonself = comm.nonself_shifts()
        routes = [(ax, "shift", sh) for (ax, sh, _w) in nonself]
        wire = self.codec.rows_wire(payload, plan)
        full, land = self._wire_buffers(payload, wire, routes)
        ops, _ = comm.exchange_ops(wire, routes, out=land,
                                   tag0=len(comm.topology.shifts))
        if self._mat_wire_static():
            x_new = self._sharded_gossip_mat(x_mat, plan, ride=ops)
        else:
            comm._p2p(*ops)
            x_new = self._gossip_mat(x_mat, r, plan=plan)
        decoded = [self.codec.rows_unpack(g, plan=plan) for g in full]
        c_new = kops.gossip_mix_mat(
            (q_self,) + tuple(decoded),
            (comm.self_weight(),) + tuple(w for (_a, _s, w) in nonself))
        return x_new, {**mats, "c": c_new}

    # -- comm-cost model --------------------------------------------------------
    def bytes_per_comm_round(self, params, r: int = 0) -> int:
        """The 2-tensor payload: full-precision x plus the correction wire
        (the codec's exact bytes when compressed, else f32 on the same
        wire as x), both × round ``r``'s degree; under membership × the
        round's active edges per worker."""
        top = self.comm.topology_at(r)
        if top.name == "hierarchical" and self.comm.membership is None:
            # x and c ship through the same two-level round
            return self.hier_bytes_per_level(params, r=r)["inter"]
        kernel_wire = self._kernel_wire_active()
        x_bytes = (top.degree * self._mat_wire_bytes(params) if kernel_wire
                   else gossip_bytes_per_round(params, self.comm, r=r))
        sizes = [int(np.prod(tuple(l.shape), dtype=np.int64))
                 for l in tree_leaves(params)]
        if self.codec is not None:
            c_payload = sum(self.codec.wire_bytes(n) for n in sizes)
        elif kernel_wire:
            c_payload = self._mat_wire_bytes(params)
        else:
            c_payload = sum(sizes) * min(4, self.comm.wire_itemsize)
        return x_bytes + self.comm.edges_per_worker(r) * c_payload

    def hier_bytes_per_level(self, params, r: int = 0) -> dict:
        """MT gossips the ``(x, c)`` pair: every level of the two-level
        round runs twice, so each entry doubles."""
        levels = super().hier_bytes_per_level(params, r=r)
        return {k: 2 * v for k, v in levels.items()}


class QGDSGDm(PDSGDM):
    """Quasi-global momentum, periodic form.  Gossips x only."""

    def __init__(self, config: QGDSGDMConfig, comm: CommBackend):
        if config.nesterov:
            raise ValueError(
                "QG-DSGDm has no nesterov variant: the quasi-global buffer "
                "is a displacement average, not a gradient accumulator")
        super().__init__(config, comm)
        # 1 − μ rounded in f32, as the reference computes it
        self._one_minus_mu = float(np.float32(1.0) - np.float32(config.mu))

    # -- state ---------------------------------------------------------------
    def init(self, params) -> dict:
        state = super().init(params)
        # the previous round's post-gossip params (f32 master copy)
        state["xprev"] = tree_map(
            lambda x: x.detach().to(torch.float32, copy=True), params)
        return state

    # -- local step: momentum-corrected gradient, frozen buffer ----------------
    def local_step(self, state, params, grads):
        """x − η(μm + ĝ), rounded as the momentum kernel's x update; m does
        not move."""
        cfg = self.config
        lr = cfg.lr(state["step"])

        def upd(x, m, g):
            x32 = x.to(torch.float32)
            d = cfg.mu * m + (g.to(torch.float32) + cfg.weight_decay * x32)
            return (x32 - lr * d).to(x.dtype)

        new_state = dict(state)
        new_state["step"] = state["step"] + 1
        return tree_map(upd, params, state["m"], grads), new_state

    def _round_inv(self, r) -> torch.Tensor:
        """1/(η p), with η at the round's last local step (t = (r+1)·p − 1):
        the normalizer of the displacement → direction conversion."""
        cfg = self.config
        if not isinstance(r, torch.Tensor):     # the sharded host round
            r = torch.tensor(r, device=self.comm.device)
        return 1.0 / (cfg.lr((r + 1) * cfg.p - 1) * cfg.p)

    def _fold(self, m, xprev, x_mixed, inv):
        """μm + (1−μ)(x_prev − x_mixed)/(ηp)."""
        d_hat = (xprev - x_mixed.to(torch.float32)) * inv
        return self.config.mu * m + self._one_minus_mu * d_hat

    # -- communication: mix, then fold the global displacement into m ----------
    def comm_round(self, state, params):
        r = self.round_index(state)
        mixed = self.comm.mix(params, r=r)
        inv = self._round_inv(r)
        new_state = dict(state)
        new_state["m"] = tree_map(lambda m, xp, xm: self._fold(m, xp, xm, inv),
                                  state["m"], state["xprev"], mixed)
        new_state["xprev"] = tree_map(lambda x: x.to(torch.float32), mixed)
        return mixed, new_state

    # -- overlapped rounds ------------------------------------------------------
    # The stale correction lands on the drifted params at round end; the
    # buffer then folds the realized round displacement (x_prev − x)/(ηp)
    # as in the synchronous form.  On round 0 (gate 0) that is the local
    # round displacement.
    def overlap_apply(self, state, params, delta):
        """The tree form, rounded as the reference's:
        μm + ((1−μ)(x_prev − x))·(1/(ηp))."""
        mu = self.config.mu
        inv = self._round_inv(self.round_index(state))
        x32 = tree_map(lambda x, d: x.to(torch.float32) + d, params,
                       delta["dx"])
        new_state = dict(state)
        new_state["m"] = tree_map(
            lambda m, xp, xn: mu * m + self._one_minus_mu * (xp - xn) * inv,
            state["m"], state["xprev"], x32)
        new_state["xprev"] = x32
        params_new = tree_map(lambda x32_, x: x32_.to(x.dtype), x32, params)
        new_state["mix"] = self._snapshot_mix(new_state, params_new)
        return params_new, new_state

    # -- kernel round ----------------------------------------------------------
    def mat_state(self, plan, state) -> dict:
        mats = super().mat_state(plan, state)
        mats["xprev"] = plan.flatten(state["xprev"])
        return mats

    def unmat_state(self, plan, mats, state, step) -> dict:
        new_state = super().unmat_state(plan, mats, state, step)
        new_state["xprev"] = plan.unflatten(mats["xprev"],
                                            dtype=torch.float32)
        return new_state

    def local_step_mat(self, x_mat, mats, g, step):
        """One momentum launch; its m is discarded (the buffer moves only
        at a gossip)."""
        cfg = self.config
        x_new, _ = kops.momentum_update_mat(
            x_mat, mats["m"], kops.as_matrix(g), mu=cfg.mu, lr=cfg.lr(step),
            weight_decay=cfg.weight_decay, nesterov=False)
        return x_new, mats

    def comm_round_mat(self, x_mat, mats, counts, r, *, plan=None):
        x_new = self._gossip_mat(x_mat, r, plan=plan)
        m_new = self._fold(mats["m"], mats["xprev"], x_new,
                           self._round_inv(r))
        return x_new, {**mats, "m": m_new, "xprev": x_new}

    def overlap_apply_mat(self, x_mat, mats, delta, r):
        """Land the stale correction (``ops.delayed_mix_mat``), fold the
        displacement into m as :meth:`comm_round_mat` does, and cut the
        next payload."""
        x_new = kops.delayed_mix_mat(x_mat, delta["dx"])
        m_new = self._fold(mats["m"], mats["xprev"], x_new,
                           self._round_inv(r))
        return x_new, {**mats, "m": m_new, "xprev": x_new,
                       "mix_buf": x_new}
