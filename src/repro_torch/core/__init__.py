"""Core of the port: topologies, the dense gossip backend, LR schedules and
PD-SGDM (paper Algorithm 1)."""
from repro_torch.core import schedules, topology
from repro_torch.core.baselines import make_optimizer
from repro_torch.core.gossip import (CommBackend, DenseComm,
                                     gossip_bytes_per_round)
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig
from repro_torch.core.topology import Topology, complete, ring, torus

__all__ = [
    "topology", "schedules",
    "Topology", "ring", "torus", "complete",
    "CommBackend", "DenseComm", "gossip_bytes_per_round",
    "PDSGDM", "PDSGDMConfig", "make_optimizer",
]
