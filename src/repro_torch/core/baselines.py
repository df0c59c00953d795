"""Baselines and the optimizer factory.  Port of
``src/repro/core/baselines.py:60-147``:

* **D-SGD** [Lian et al. '17]: gossip every step, no momentum;
* **PD-SGD** [Li et al. '19]: periodic gossip, no momentum;
* **CHOCO-SGD** [Koloskova et al. '19]: compressed gossip every step, no
  momentum, built on CPD-SGDM's comm round, so it ships the real codec
  payload.

C-SGDM (ROADMAP queue A item 4) and MT-/QG-DSGDm (item 8) are not ported
yet; :func:`make_optimizer` raises for their names, naming the item.
"""
from __future__ import annotations

from repro_torch.core.compression import Compressor
from repro_torch.core.cpdsgdm import CPDSGDM, CPDSGDMConfig
from repro_torch.core.gossip import CommBackend
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig

__all__ = ["d_sgd", "pd_sgd", "choco_sgd", "make_optimizer"]

_NOT_YET = {
    ("c_sgdm", "csgdm"): "C-SGDM is ROADMAP queue A item 4",
    ("mt_dsgdm", "mtdsgdm", "mt", "qg_dsgdm", "qgdsgdm", "qg"):
        "MT-DSGDm and QG-DSGDm are ROADMAP queue A item 8",
}


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
    if name in ("cpd_sgdm", "cpdsgdm"):
        return CPDSGDM(CPDSGDMConfig(eta=eta, mu=mu, p=p, gamma=gamma,
                                     weight_decay=weight_decay,
                                     lr_schedule=lr_schedule,
                                     use_kernel=use_kernel,
                                     overlap=overlap),
                       comm, compressor)
    if name in ("d_sgd", "dsgd"):
        return d_sgd(eta, comm, weight_decay)
    if name in ("pd_sgd", "pdsgd"):
        if overlap:
            raise NotImplementedError(
                "overlapped rounds are ROADMAP queue A item 9")
        return pd_sgd(eta, p, comm, weight_decay)
    if name in ("choco_sgd", "chocosgd", "choco"):
        return choco_sgd(eta, gamma, comm, compressor, weight_decay)
    for names, why in _NOT_YET.items():
        if name in names:
            raise NotImplementedError(f"{name}: not ported yet — {why}")
    raise ValueError(f"unknown optimizer {name!r}")
