"""Optimizer factory.  Port of ``make_optimizer`` in
``src/repro/core/baselines.py``; this slice carries PD-SGDM only, and every
other name raises, naming the ROADMAP queue A item that brings it."""
from __future__ import annotations

from repro_torch.core.gossip import CommBackend
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig

__all__ = ["make_optimizer"]

_NOT_YET = {
    ("c_sgdm", "csgdm"): "C-SGDM is ROADMAP queue A item 4",
    ("cpd_sgdm", "cpdsgdm", "d_sgd", "dsgd", "pd_sgd", "pdsgd",
     "choco_sgd", "chocosgd", "choco"):
        "CPD-SGDM and the momentum-free baselines are ROADMAP queue A item 5",
    ("mt_dsgdm", "mtdsgdm", "mt", "qg_dsgdm", "qgdsgdm", "qg"):
        "MT-DSGDm and QG-DSGDm are ROADMAP queue A item 8",
}


def make_optimizer(name: str, comm: CommBackend, *, eta: float = 0.1,
                   mu: float = 0.9, p: int = 4, weight_decay: float = 0.0,
                   lr_schedule=None, use_kernel: bool = False,
                   overlap: bool = False):
    """Factory used by the trainers and ``chip_smoke.py``."""
    name = name.lower().replace("-", "_")
    if name in ("pd_sgdm", "pdsgdm"):
        return PDSGDM(PDSGDMConfig(eta=eta, mu=mu, p=p,
                                   weight_decay=weight_decay,
                                   lr_schedule=lr_schedule,
                                   use_kernel=use_kernel,
                                   overlap=overlap), comm)
    for names, why in _NOT_YET.items():
        if name in names:
            raise NotImplementedError(f"{name}: not ported yet — {why}")
    raise ValueError(f"unknown optimizer {name!r}")
