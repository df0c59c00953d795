"""PD-SGDM — Periodic Decentralized Momentum SGD (paper Algorithm 1).

Port of ``src/repro/core/pdsgdm.py:36-620`` on the dense simulation
backend and on the sharded backends (one worker per rank), over a static
graph, a time-varying schedule or a hierarchical graph, with or without
elastic membership (a churn round mixes with its masked W through
``comm.mix`` and is charged its live edges only).
Per worker k, per iteration t::

    m⁽ᵏ⁾ₜ   = μ m⁽ᵏ⁾ₜ₋₁ + ∇F(x⁽ᵏ⁾ₜ; ξ⁽ᵏ⁾ₜ)
    x⁽ᵏ⁾ₜ₊½ = x⁽ᵏ⁾ₜ − η m⁽ᵏ⁾ₜ
    x⁽ᵏ⁾ₜ₊₁ = Σⱼ w_kj x⁽ʲ⁾ₜ₊½      if mod(t+1, p) == 0   (gossip)
            = x⁽ᵏ⁾ₜ₊½              otherwise

Weight decay is folded into the gradient before the momentum update
(PyTorch SGD semantics, as in the paper's experiments).

Params are flat worker-stacked dicts (:mod:`repro_torch.tree`).  The fused
round runs p local steps as a Python loop and then one unconditional
gossip; with ``use_kernel`` it runs on the flatten-once ``(K, rows, 1024)``
layout through the CUDA kernels (:meth:`PDSGDM.kernel_round`).  The step
counter and the learning rate stay 0-d tensors on the device: a round
makes no host sync.

* **Overlapped rounds** (``overlap=True``): round r's gossip payload, the
  f32 snapshot of the params at round r's end, is exchanged at the start
  of round r+1 and lands one round stale at its end,
  ``x ← x + gate·(W̃·buf − buf)`` with W̃ the delivery's
  (:meth:`~repro_torch.core.gossip.CommBackend.effective_stale_matrix`).
  ``state["mix"]`` carries the in-flight ``buf`` and the staleness
  ``phase``; round 0 has nothing in flight, and its gate (``phase > 0``, a
  0-d device tensor) makes the correction an exact no-op while the
  exchange still runs.  On the kernel layout the stale mix is the gossip
  kernel (or ``W̃ @ x`` on the matrix) and the landing is
  ``ops.delayed_mix_mat``, the gossip kernel with weights (1, 1).
* **The bf16 wire** (``DenseComm(..., wire_dtype="bfloat16")``): on the
  kernel layout the shifted mix reads the self view from the f32 matrix
  and the neighbour views from its bf16 round trip (``nbr``), and each
  neighbour exchange is charged 2 bytes an element.
* **The sharded backends** (:class:`~repro_torch.core.gossip.ShardedComm`):
  each rank holds its worker with a leading worker dim of 1.  On the
  kernel layout the payload is cut to ``plan.used_rows``, shipped in the
  wire dtype, received into zero-tailed full-size buffers held per plan
  geometry, and the self view and the received views, in the topology's
  order, go to the n-matrix ``gossip_mix`` kernel: one launch per axis.
  A ``HierarchicalComm`` on a static graph mixes through its ``mix_mat``.
  The sharded comm picks round r's exchanges on the host, so the sharded
  runtime hands the optimizer the host step (``host_step``), which it
  keeps in step with the device counter: no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.gossip import (CommBackend, HierarchicalComm,
                                     ShardedComm, bf16_round_trip,
                                     gossip_bytes_per_round,
                                     hier_bytes_per_round)
from repro_torch.kernels import LANE
from repro_torch.kernels import ops as kops
from repro_torch.spans import ROUND_EXCHANGE, ROUND_GRAD, span
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["PDSGDMConfig", "PDSGDM"]


def _unstack(batches) -> list:
    """A batch dict with a leading dim of n → n batch dicts."""
    n = next(iter(batches.values())).shape[0]
    return [{k: v[i] for k, v in batches.items()} for i in range(n)]


@dataclasses.dataclass(frozen=True)
class PDSGDMConfig:
    eta: float = 0.1                 # step size η (peak LR if schedule given)
    mu: float = 0.9                  # momentum coefficient μ ∈ [0, 1)
    p: int = 4                       # communication period
    weight_decay: float = 0.0
    nesterov: bool = False           # beyond-paper option (off by default)
    lr_schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # the fused round runs on the flatten-once (rows, 1024) kernel layout
    use_kernel: bool = False
    # one-round-stale gossip hidden behind the local steps
    overlap: bool = False

    def lr(self, step: torch.Tensor) -> torch.Tensor:
        """The 0-d f32 learning rate of ``step``, on its device."""
        if self.lr_schedule is None:
            return torch.full((), self.eta, dtype=torch.float32,
                              device=step.device)
        return (self.eta * self.lr_schedule(step)).to(torch.float32)


class PDSGDM:
    """Algorithm 1.  ``round`` is the fused form (p local steps + one
    unconditional gossip) that :class:`~repro_torch.train.trainer.SimTrainer`
    executes."""

    def __init__(self, config: PDSGDMConfig, comm: CommBackend):
        if not (0.0 <= config.mu < 1.0):
            raise ValueError("momentum μ must be in [0, 1)")
        if config.p < 1:
            raise ValueError("communication period p must be ≥ 1")
        self.config = config
        self.comm = comm
        # device copies of KernelPlan.row_counts, tiled over the workers,
        # one per plan geometry: a steady-state round copies nothing from
        # the host
        self._counts: dict = {}
        # the sharded kernel wire's zero-tailed receive buffers, per plan
        # geometry and exchange
        self._recv: dict = {}
        # the step counter on the host, where the sharded runtime keeps it
        # (None on the dense backend): round r's sharded exchanges are
        # chosen on the host
        self.host_step: Optional[int] = None

    @property
    def sharded(self) -> bool:
        return isinstance(self.comm, ShardedComm)

    def _advance_host(self):
        if self.host_step is not None:
            self.host_step += 1

    def _round_at(self, step):
        """Round index ``step // p − 1``: from the host step where the
        sharded runtime keeps one (a host int), else from the 0-d device
        ``step``."""
        if self.host_step is not None:
            return self.host_step // self.config.p - 1
        return step // self.config.p - 1

    # -- state ---------------------------------------------------------------
    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        state = {
            "m": tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }
        if self.config.overlap:
            state["mix"] = self._delayed_mix_init(params)
        return state

    # -- DelayedMixState (overlap=True) ---------------------------------------
    # ``buf`` is the in-flight payload, the f32 snapshot cut at the end of
    # the previous round; ``phase`` is 0 before any payload was cut (round 0
    # runs the exchange but gates its correction to zero), then 1.
    def _delayed_mix_init(self, params) -> dict:
        return {
            "buf": tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                            params),
            "phase": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
        }

    # keys of the delta that overlap_begin forms (MT adds "dc")
    overlap_delta_keys: tuple = ("dx",)
    # whether overlap_step_refresh does anything (MT drips its stale
    # tracking delta into every local step)
    overlap_refreshes: bool = False

    # -- local computation (Alg. 1 lines 2-4) ---------------------------------
    def local_step(self, state, params, grads):
        """One momentum step on the param tree, each op rounded as the
        fused kernel rounds it (the tree path; ``use_kernel`` rounds go
        through :meth:`kernel_round` instead)."""
        cfg = self.config
        lr = cfg.lr(state["step"])

        def upd(x, m, g):
            x32 = x.to(torch.float32)
            g32 = g.to(torch.float32) + cfg.weight_decay * x32
            m_new = cfg.mu * m + g32
            d = (g32 + cfg.mu * m_new) if cfg.nesterov else m_new
            return (x32 - lr * d).to(x.dtype), m_new

        pairs = tree_map(upd, params, state["m"], grads)
        new_state = dict(state)
        new_state["m"] = {k: m for k, (_, m) in pairs.items()}
        new_state["step"] = state["step"] + 1
        return {k: x for k, (x, _) in pairs.items()}, new_state

    # -- communication (Alg. 1 lines 5-9) --------------------------------------
    def round_index(self, state):
        """0-based index of the gossip round being applied: ``comm_round``
        runs after the local steps advanced the counter to (r+1)·p.  A host
        int where the sharded runtime keeps the host step."""
        return self._round_at(state["step"])

    def comm_round(self, state, params):
        """One gossip round (unconditional), with round ``r``'s topology."""
        return self.comm.mix(params, r=self.round_index(state)), state

    def is_comm_step(self, state) -> torch.Tensor:
        """mod(t+1, p) == 0 after the local step advanced the counter: a
        0-d bool tensor on the counter's device."""
        return (state["step"] % self.config.p) == 0

    def maybe_communicate(self, state, params):
        """The gossip round if this step ends a round.  The per-step form
        is not the hot path: it reads :meth:`is_comm_step` on the host, one
        sync a step (the fused :meth:`round` makes none)."""
        if bool(self.is_comm_step(state)):
            return self.comm_round(state, params)
        return params, state

    # -- overlapped rounds: one-round-stale delayed mixing ----------------------
    def overlap_begin(self, state) -> dict:
        """Exchange the in-flight payload and form the stale correction.
        At round start ``round_index(state)`` is the payload's round r
        (step = (r+1)·p): the topology keys on r, the membership mask on
        the delivery round r+1 (``comm.stale_mix``).  ``phase == 0`` gates
        the correction to zero; the exchange runs all the same."""
        mix = state["mix"]
        gate = (mix["phase"] > 0).to(torch.float32)
        mixed = self.comm.stale_mix(mix["buf"], r=self.round_index(state))
        return {"dx": tree_map(lambda mb, b: (mb - b) * gate, mixed,
                               mix["buf"])}

    def overlap_step_refresh(self, state, delta):
        """Per-local-step refresh from the in-flight payload: nothing here
        (MT-DSGDm drips its stale tracking delta through it)."""
        return state

    def overlap_apply(self, state, params, delta):
        """Land the stale correction on the drifted params at the round's
        end, then cut the next payload (:meth:`_snapshot_mix`)."""
        params_new = tree_map(lambda x, d: (x.to(torch.float32) + d)
                              .to(x.dtype), params, delta["dx"])
        new_state = dict(state)
        new_state["mix"] = self._snapshot_mix(new_state, params_new)
        return params_new, new_state

    def _snapshot_mix(self, state, params) -> dict:
        """The next payload: the params in f32 (sharing their storage, as
        the reference's arrays share it: nothing in the port writes params
        in place), phase 1."""
        return {"buf": tree_map(lambda x: x.to(torch.float32), params),
                "phase": torch.ones((), dtype=torch.int32,
                                    device=state["step"].device)}

    # -- full iteration ---------------------------------------------------------
    def step(self, state, params, grads):
        """One iteration in the per-step form: the local step, then the
        gossip if the step ends a round.  With ``overlap`` the correction
        is formed from the in-flight payload at every step (it depends on
        that payload alone, so each step's equals the fused round's) and
        lands at the step that ends the round, so a run resumed mid-round
        from a saved state continues it.  Each step reads the step counter
        on the host (:meth:`maybe_communicate`)."""
        if self.config.overlap:
            delta = self.overlap_begin(state)
            params, state = self.local_step(state, params, grads)
            self._advance_host()
            state = self.overlap_step_refresh(state, delta)
            if bool(self.is_comm_step(state)):
                params, state = self.overlap_apply(state, params, delta)
            return params, state
        params, state = self.local_step(state, params, grads)
        self._advance_host()
        return self.maybe_communicate(state, params)

    # -- fused round (the hot path) ---------------------------------------------
    def round(self, state, params, grads_fn, batches, *, gossip=True):
        """p local steps then exactly one unconditional gossip round.

        ``grads_fn(params, batch) -> (loss, grads)``; ``batches`` is a dict
        whose values carry a leading dim of length p.  ``gossip=False`` runs
        a tail of local steps only (a run whose length is not a multiple of
        p).  With ``use_kernel`` the round runs on the flatten-once layout
        (:meth:`kernel_round`).  With ``overlap`` the in-flight payload is
        exchanged at the start (:meth:`overlap_begin`; in a tail only if
        the optimizer refreshes its state from it), the local steps run
        without depending on it (MT's refresh excepted) and the stale
        correction lands at the end (:meth:`overlap_apply`), which cuts the
        next payload.  Returns ``(params, state, losses)`` with ``losses``
        stacked over the local steps, on the device.
        """
        if self.config.use_kernel:
            return self.kernel_round(state, params, grads_fn, batches,
                                     gossip=gossip)
        overlap = self.config.overlap
        delta = (self.overlap_begin(state)
                 if overlap and (gossip or self.overlap_refreshes) else None)
        losses = []
        for batch in _unstack(batches):
            with span(ROUND_GRAD):
                loss, grads = grads_fn(params, batch)
            params, state = self.local_step(state, params, grads)
            self._advance_host()
            if delta is not None and self.overlap_refreshes:
                state = self.overlap_step_refresh(state, delta)
            losses.append(loss)
        if gossip:
            with span(ROUND_EXCHANGE):
                if overlap:
                    params, state = self.overlap_apply(state, params, delta)
                else:
                    params, state = self.comm_round(state, params)
        return params, state, torch.stack(losses)

    # -- kernel round: flatten once, local steps + gossip on (K, rows, 1024) --
    @property
    def kernel_comm_supported(self) -> bool:
        """Whether :meth:`comm_round_mat` can run this optimizer's gossip on
        the kernel matrix (PD-SGDM: always).  Where it cannot,
        :meth:`kernel_round` unflattens and runs the tree ``comm_round`` at
        the round boundary."""
        return True

    def row_counts(self, plan, mat) -> torch.Tensor:
        """``plan.row_counts()`` on ``mat``'s device, tiled over its leading
        worker dims: built and copied once per plan geometry."""
        lead = tuple(mat.shape[:-2])
        key = (plan, lead, mat.device)
        counts = self._counts.get(key)
        if counts is None:
            counts = kops.tile_counts(plan.row_counts(mat.device), plan.rows,
                                      lead)
            self._counts[key] = counts
        return counts

    def mat_state(self, plan, state) -> dict:
        """Flatten the per-element optimizer state into kernel matrices."""
        mats = {"m": plan.flatten(state["m"])}
        if self.config.overlap:
            mats["mix_buf"] = plan.flatten(state["mix"]["buf"])
        return mats

    def unmat_state(self, plan, mats, state, step) -> dict:
        new_state = dict(state)
        new_state["m"] = plan.unflatten(mats["m"], dtype=torch.float32)
        new_state["step"] = step
        if self.config.overlap:
            new_state["mix"] = {
                **state["mix"],
                "buf": plan.unflatten(mats["mix_buf"], dtype=torch.float32)}
        return new_state

    def local_step_mat(self, x_mat, mats, g, step):
        """One fused momentum update on the kernel layout (one launch),
        written over ``x_mat`` and ``mats["m"]``: both belong to the round
        (fresh from :meth:`KernelPlan.flatten` or from this launch), so no
        one else sees them change, and the round holds no copy of x' and
        m' beside x and m.  ``g``: the gradient as ``kops.Leaves``, which
        the launch reads leaf by leaf where autograd left them (no
        gradient matrix is built), or as a matrix.  An override that needs
        the gradient as a matrix takes ``kops.as_matrix(g)``."""
        cfg = self.config
        x_new, m_new = kops.momentum_update_mat(
            x_mat, mats["m"], g, mu=cfg.mu, lr=cfg.lr(step),
            weight_decay=cfg.weight_decay, nesterov=cfg.nesterov,
            inplace=True)
        return x_new, {**mats, "m": m_new}

    def _mat_wire_static(self) -> bool:
        """Whether :meth:`_gossip_mat` runs the shift-structured AXPY wire,
        whose neighbour exchanges ship the ``plan.used_rows`` extent: a
        static graph (period 1), no membership schedule, no perms, and
        neither complete nor disconnected.  Every other graph mixes through
        ``comm.mix`` on the matrix."""
        top = self.comm.topology
        return (self.comm.period == 1
                and self.comm.membership is None
                and not top.perms
                and top.name not in ("complete", "disconnected",
                                     "hierarchical"))

    def _gossip_mat(self, x_mat, r, *, plan=None):
        """Gossip mix on the kernel layout: one fused AXPY per topology
        axis that reads the self view and the shifted neighbour views of
        ``x_mat`` in place (one launch up to 32 views: the exponential
        graph's 9 at K = 16 too); other graphs take ``comm.mix`` on the
        matrix with round ``r``'s W.  With a ``plan`` each neighbour view
        reads only the ``used_rows`` wire extent and zeros past it, so what
        is exchanged is what is accounted.  On the bf16 wire the neighbour
        views read the bf16 round trip of each axis's payload and the self
        view the f32 matrix."""
        if not self._mat_wire_static():
            comm = self.comm
            if isinstance(comm, HierarchicalComm) and comm.period == 1:
                return comm.mix_mat(x_mat, plan=plan)
            return comm.mix(x_mat, r=r)
        if self.sharded:
            return self._sharded_gossip_mat(x_mat, plan)
        top = self.comm.topology
        lim = plan.used_rows if plan is not None else None
        bf16 = self.comm.wire_dtype == "bfloat16"
        per_axis: dict = {}
        for (ax, sh, w) in top.shifts:
            per_axis.setdefault(ax, []).append((sh, w))
        y = x_mat
        for ax in sorted(per_axis):
            shifts, weights = zip(*per_axis[ax])
            y = kops.gossip_mix_shifted(y, grid=top.axis_sizes, axis=ax,
                                        shifts=shifts, weights=weights,
                                        lim=lim,
                                        nbr=bf16_round_trip(y) if bf16
                                        else None)
        return y

    def _recv_buffers(self, shape, u, ax, j, dtype):
        """Exchange j of axis ``ax``'s receive buffers for a ``shape``
        matrix: the f32 view matrix, zero past row ``u`` (kept zero: only
        rows below ``u`` are ever written), and on the bf16 wire the i16
        buffer the payload lands in."""
        key = (tuple(shape), u, ax, j, dtype, self.comm.device)
        bufs = self._recv.get(key)
        if bufs is None:
            full = torch.zeros(shape, dtype=torch.float32,
                               device=self.comm.device)
            wire = (torch.empty(shape[:-2] + (u, shape[-1]), dtype=dtype,
                                device=self.comm.device)
                    if dtype != torch.float32 else full[..., :u, :])
            bufs = self._recv[key] = (full, wire)
        return bufs

    def _wire_buffers(self, payload, wire, routes) -> tuple:
        """The receive buffers of a codec's kernel wire (``wire``: the
        ``rows_wire`` cut of ``payload``), held per shift, array and
        geometry: per ``(axis, "shift", shift)`` route the full-size arrays
        the received payload decodes from (zero past the wire's rows, which
        are never written) and the wire-shaped parts of them the exchange
        lands in."""
        full, land = [], []
        for (ax, _kind, sh) in routes:
            f, g = {}, {}
            for name, arr in payload.items():
                cut = tuple(wire[name].shape)
                key = ("codec", ax, sh, name, tuple(arr.shape), cut,
                       arr.dtype, arr.device)
                bufs = self._recv.get(key)
                if bufs is None:
                    whole = torch.zeros(arr.shape, dtype=arr.dtype,
                                        device=arr.device)
                    part = (whole if cut == tuple(arr.shape)
                            else whole[..., :cut[-2], :])
                    bufs = self._recv[key] = (whole, part)
                f[name], g[name] = bufs
            full.append(f)
            land.append(g)
        return full, land

    def _sharded_gossip_mat(self, x_mat, plan, ride=None):
        """The shift-structured wire on a ``ShardedComm``: per topology
        axis, the ``used_rows`` cut of the matrix ships in the wire dtype
        to every neighbour of the axis in one batch, lands in the held
        zero-tailed buffers, and the self view and the received views, in
        the topology's order, go to one ``gossip_mix`` launch.  ``ride``:
        ``(sends, recvs)`` of another payload (tags past the topology's
        shifts) posted in the first axis's batch."""
        comm = self.comm
        top = comm.topology
        rows = x_mat.shape[-2]
        u = plan.used_rows if plan is not None else rows
        per_axis: dict = {}
        for (ax, sh, w) in top.shifts:
            per_axis.setdefault(ax, []).append((sh, w))
        y = x_mat
        for ax in sorted(per_axis):
            payload = comm._wire_cast(y[..., :u, :]).contiguous()
            sends, recvs, views = [], [], []
            for j, (sh, _w) in enumerate(per_axis[ax]):
                if sh == 0:
                    views.append(y)
                    continue
                full, wire = self._recv_buffers(tuple(y.shape), u, ax, j,
                                                payload.dtype)
                dst, src = comm._ends(ax, "shift", sh)
                sends.append((payload, dst, j))
                recvs.append((wire, src, j))
                views.append((full, wire))
            if ride is not None:
                sends, recvs = sends + ride[0], recvs + ride[1]
                ride = None
            comm._p2p(sends, recvs)
            for v in views:
                if isinstance(v, tuple) and v[1].dtype != torch.float32:
                    v[0][..., :u, :].copy_(comm._unwire_cast(v[1]))
            views = [v[0] if isinstance(v, tuple) else v for v in views]
            y = kops.gossip_mix_mat(tuple(views),
                                    tuple(w for (_sh, w) in per_axis[ax]))
        return y

    def comm_round_mat(self, x_mat, mats, counts, r, *, plan=None):
        """One gossip round on the kernel layout (``counts`` is unused here;
        the compressed wire of CPD-SGDM reads it)."""
        return self._gossip_mat(x_mat, r, plan=plan), mats

    # -- overlapped rounds on the kernel layout ---------------------------------
    def _stale_gossip_mat(self, x_mat, r, *, plan=None):
        """The stale mix on the matrix: the shift-structured wire where it
        runs (no membership there, so stale and regular coincide), else
        ``comm.stale_mix``, whose membership mask keys on the delivery
        round r+1."""
        if self._mat_wire_static() or (
                isinstance(self.comm, HierarchicalComm)
                and self.comm.period == 1):
            return self._gossip_mat(x_mat, r, plan=plan)
        return self.comm.stale_mix(x_mat, r=r)

    def overlap_begin_mat(self, mats, r, gate, *, plan=None) -> dict:
        """:meth:`overlap_begin` on the matrix; ``gate`` is the 0-d f32
        staleness gate, folded by a multiply (the kernel's weights are
        static)."""
        buf = mats["mix_buf"]
        return {"dx": (self._stale_gossip_mat(buf, r, plan=plan) - buf)
                * gate}

    def overlap_refresh_mat(self, mats, delta):
        """Per-local-step refresh on the matrix: nothing here (MT drips)."""
        return mats

    def overlap_apply_mat(self, x_mat, mats, delta, r):
        """Land the stale correction (``ops.delayed_mix_mat``, one gossip
        launch) and cut the next payload: the landed matrix itself.  ``r``
        is the landing round (QG's normalizer keys on it)."""
        x_new = kops.delayed_mix_mat(x_mat, delta["dx"])
        return x_new, {**mats, "mix_buf": x_new}

    def kernel_round(self, state, params, grads_fn, batches, *, gossip=True):
        """The fused round on the flatten-once kernel layout.

        Params and momentum are flattened into ``(K, rows, 1024)`` once;
        each local step evaluates the grads on views of the param matrix
        and hands them to :meth:`local_step_mat` as ``kops.Leaves``: PD's
        one momentum launch reads them where they lie, and an override
        that needs a matrix flattens them (one copy); the gossip
        runs on the same matrix; the trees are rebuilt once at the end.
        With ``overlap`` the stale correction is formed at the start, in a
        tail too (:meth:`overlap_begin_mat`), and lands at the end of a
        round (:meth:`overlap_apply_mat`).
        """
        plan = kops.KernelPlan.for_tree(params, worker_dim=True)
        x_mat = plan.flatten(params)
        mats = self.mat_state(plan, state)
        step = state["step"]
        overlap = self.config.overlap
        delta = None
        if overlap:
            if not self.kernel_comm_supported:
                raise ValueError(
                    "overlap=True on the kernel path requires matrix-domain "
                    "gossip (kernel_comm_supported)")
            # round start: step = (r+1)·p, so r is the payload's round
            gate = (state["mix"]["phase"] > 0).to(torch.float32)
            delta = self.overlap_begin_mat(mats, self._round_at(step),
                                           gate, plan=plan)
        losses = []
        for batch in _unstack(batches):
            views = plan.unflatten(x_mat)
            with span(ROUND_GRAD):
                loss, grads = grads_fn(views, batch)
            del views
            g = kops.Leaves(plan, grads)
            # hold the grad tree only until the update has read it: at full
            # width it is a copy of the params
            del grads
            x_mat, mats = self.local_step_mat(x_mat, mats, g, step)
            del g
            if overlap and self.overlap_refreshes:
                mats = self.overlap_refresh_mat(mats, delta)
            step = step + 1
            self._advance_host()
            losses.append(loss)
        r = self._round_at(step)
        if gossip and overlap:
            with span(ROUND_EXCHANGE):
                x_mat, mats = self.overlap_apply_mat(x_mat, mats, delta, r)
        elif gossip and self.kernel_comm_supported:
            with span(ROUND_EXCHANGE):
                x_mat, mats = self.comm_round_mat(
                    x_mat, mats, self.row_counts(plan, x_mat), r, plan=plan)
        params = plan.unflatten(x_mat)
        state = self.unmat_state(plan, mats, state, step)
        if gossip and overlap:
            state["mix"] = {**state["mix"],
                            "phase": torch.ones((), dtype=torch.int32,
                                                device=step.device)}
        elif gossip and not self.kernel_comm_supported:
            # e.g. CPD-SGDM with a codec that has no kernel format: the tree
            # comm round at the boundary
            with span(ROUND_EXCHANGE):
                params, state = self.comm_round(state, params)
        return params, state, torch.stack(losses)

    # -- comm-cost model ----------------------------------------------------------
    def _mat_wire_rows(self, params) -> int:
        """``used_rows`` wire extent of the kernel layout: Σ per-leaf
        ceil(size/1024) rows."""
        return sum(-(-int(np.prod(tuple(l.shape), dtype=np.int64)) // LANE)
                   for l in tree_leaves(params))

    def _mat_wire_bytes(self, params) -> int:
        """Bytes of one neighbour exchange on the kernel layout: the
        ``used_rows`` extent × 1024 at the wire dtype."""
        item = min(4, self.comm.wire_itemsize)
        return self._mat_wire_rows(params) * LANE * item

    def _kernel_wire_active(self) -> bool:
        return (self.config.use_kernel and self.kernel_comm_supported
                and self._mat_wire_static())

    def _kernel_hier_active(self) -> bool:
        """Whether the round gossips through ``HierarchicalComm.mix_mat``
        (the kernel layout, a static hierarchical graph): its inter payload
        is the ``(used_rows, 1024)`` matrix, not the leaf tree."""
        return (self.config.use_kernel and self.kernel_comm_supported
                and isinstance(self.comm, HierarchicalComm)
                and self.comm.period == 1)

    def hier_bytes_per_level(self, params, r: int = 0) -> dict:
        """Per-level bytes of hierarchical round ``r``
        (:func:`~repro_torch.core.gossip.hier_bytes_per_round`): the leaf
        tree, or on ``HierarchicalComm.mix_mat`` the ``used_rows × 1024``
        f32 matrix."""
        payload = params
        if self._kernel_hier_active():
            payload = torch.empty((self._mat_wire_rows(params) * LANE,),
                                  dtype=torch.float32, device="meta")
        return hier_bytes_per_round(payload, self.comm, r=r)

    def bytes_per_comm_round(self, params, r: int = 0) -> int:
        """Per-worker bytes of gossip round ``r``; ``params`` is one
        worker's tree (no worker dim).  A hierarchical round without
        membership is charged its slow-link level."""
        if (self.comm.topology_at(r).name == "hierarchical"
                and self.comm.membership is None):
            return self.hier_bytes_per_level(params, r=r)["inter"]
        if self._kernel_wire_active():
            return self.comm.topology_at(r).degree * self._mat_wire_bytes(params)
        return gossip_bytes_per_round(params, self.comm, r=r)

    def bytes_per_round_cycle(self, params) -> tuple:
        """Per-round bytes over one schedule cycle (a 1-tuple for a static
        graph); the trainer accumulates these for comm-MB accounting."""
        return tuple(self.bytes_per_comm_round(params, r=r)
                     for r in range(self.comm.round_cycle))
