"""Baselines and the optimizer factory.  Port of
``src/repro/core/baselines.py:30-147``:

* **C-SGDM**: centralized momentum SGD (the paper's Fig. 1 reference):
  gradients are averaged over all workers every step, so the replicas
  stay identical.  It mixes the gradients with the complete topology
  (``W @ g`` on the dense backend, an ``all_reduce`` mean on the sharded
  one), so it shares the momentum kernel with the decentralized methods;
* **D-SGD** [Lian et al. '17]: gossip every step, no momentum;
* **PD-SGD** [Li et al. '19]: periodic gossip, no momentum;
* **CHOCO-SGD** [Koloskova et al. '19]: compressed gossip every step, no
  momentum, built on CPD-SGDM's comm round, so it ships the real codec
  payload.

:func:`make_optimizer` also builds MT-DSGDm and QG-DSGDm
(:mod:`repro_torch.core.tracking`) under the reference's names.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.compression import Compressor
from repro_torch.core.cpdsgdm import CPDSGDM, CPDSGDMConfig
from repro_torch.core.gossip import CommBackend, DenseComm, ShardedComm
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig
from repro_torch.core.topology import complete
from repro_torch.core.tracking import (MTDSGDMConfig, MTDSGDm, QGDSGDMConfig,
                                       QGDSGDm)
from repro_torch.kernels import ops as kops

__all__ = ["CSGDM", "d_sgd", "pd_sgd", "choco_sgd", "make_optimizer"]


class CSGDM(PDSGDM):
    """Centralized momentum SGD: the mean of the gradients every step,
    through ``comm.mix`` with the complete topology (W = 11ᵀ/K)."""

    def __init__(self, config: PDSGDMConfig, comm: CommBackend):
        super().__init__(dataclasses.replace(config, p=1), comm)
        if comm.topology.name != "complete":
            raise ValueError("C-SGDM requires the complete topology (mean)")

    def local_step(self, state, params, grads):
        return super().local_step(state, params, self.comm.mix(grads))

    def comm_round(self, state, params):
        return params, state               # params never drift

    # the kernel round: the mean of the gradient matrix, then one momentum
    # launch; no gossip
    def local_step_mat(self, x_mat, mats, g, step):
        return super().local_step_mat(
            x_mat, mats, self.comm.mix(kops.as_matrix(g)), step)

    def comm_round_mat(self, x_mat, mats, counts, r, *, plan=None):
        return x_mat, mats


def d_sgd(eta: float, comm: CommBackend, weight_decay: float = 0.0) -> PDSGDM:
    return PDSGDM(PDSGDMConfig(eta=eta, mu=0.0, p=1,
                               weight_decay=weight_decay), comm)


def pd_sgd(eta: float, p: int, comm: CommBackend,
           weight_decay: float = 0.0) -> PDSGDM:
    return PDSGDM(PDSGDMConfig(eta=eta, mu=0.0, p=p,
                               weight_decay=weight_decay), comm)


def choco_sgd(eta: float, gamma: float, comm: CommBackend,
              compressor: Compressor | None = None,
              weight_decay: float = 0.0) -> CPDSGDM:
    cfg = CPDSGDMConfig(eta=eta, mu=0.0, p=1, gamma=gamma,
                        weight_decay=weight_decay)
    return CPDSGDM(cfg, comm, compressor)


def make_optimizer(name: str, comm: CommBackend, *, eta: float = 0.1,
                   mu: float = 0.9, p: int = 4, gamma: float = 0.4,
                   weight_decay: float = 0.0, compressor=None,
                   lr_schedule=None, use_kernel: bool = False,
                   overlap: bool = False):
    """Factory used by the trainers and ``chip_smoke.py``.  As in the
    reference, D-SGD, PD-SGD and CHOCO-SGD ignore ``use_kernel`` and
    ``lr_schedule``."""
    name = name.lower().replace("-", "_")
    if overlap and name in ("c_sgdm", "csgdm", "d_sgd", "dsgd",
                            "choco_sgd", "chocosgd", "choco"):
        raise ValueError(
            f"{name}: overlap=True needs a periodic round to hide the "
            "exchange behind (p > 1 local steps); every-step methods have "
            "no local steps to overlap")
    if name in ("pd_sgdm", "pdsgdm"):
        return PDSGDM(PDSGDMConfig(eta=eta, mu=mu, p=p,
                                   weight_decay=weight_decay,
                                   lr_schedule=lr_schedule,
                                   use_kernel=use_kernel,
                                   overlap=overlap), comm)
    if name in ("mt_dsgdm", "mtdsgdm", "mt"):
        return MTDSGDm(MTDSGDMConfig(eta=eta, mu=mu, p=p,
                                     weight_decay=weight_decay,
                                     lr_schedule=lr_schedule,
                                     use_kernel=use_kernel,
                                     overlap=overlap),
                       comm, compressor)
    if name in ("qg_dsgdm", "qgdsgdm", "qg"):
        return QGDSGDm(QGDSGDMConfig(eta=eta, mu=mu, p=p,
                                     weight_decay=weight_decay,
                                     lr_schedule=lr_schedule,
                                     use_kernel=use_kernel,
                                     overlap=overlap),
                       comm)
    if name in ("cpd_sgdm", "cpdsgdm"):
        return CPDSGDM(CPDSGDMConfig(eta=eta, mu=mu, p=p, gamma=gamma,
                                     weight_decay=weight_decay,
                                     lr_schedule=lr_schedule,
                                     use_kernel=use_kernel,
                                     overlap=overlap),
                       comm, compressor)
    if name in ("c_sgdm", "csgdm"):
        if comm.topology.name == "hierarchical":
            raise ValueError(
                "c_sgdm is the centralized baseline (complete-graph mean "
                "every step); hierarchical gossip does not apply")
        K = comm.topology.n_workers
        mean = (ShardedComm(complete(K), axis_names=comm.axis_names,
                            mesh=comm.mesh)
                if isinstance(comm, ShardedComm)
                else DenseComm(complete(K), device=comm.device))
        return CSGDM(PDSGDMConfig(eta=eta, mu=mu, p=1,
                                  weight_decay=weight_decay,
                                  lr_schedule=lr_schedule,
                                  use_kernel=use_kernel), mean)
    if name in ("d_sgd", "dsgd"):
        return d_sgd(eta, comm, weight_decay)
    if name in ("pd_sgd", "pdsgd"):
        if overlap:
            return PDSGDM(PDSGDMConfig(eta=eta, mu=0.0, p=p,
                                       weight_decay=weight_decay,
                                       overlap=True), comm)
        return pd_sgd(eta, p, comm, weight_decay)
    if name in ("choco_sgd", "chocosgd", "choco"):
        return choco_sgd(eta, gamma, comm, compressor, weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
