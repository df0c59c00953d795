"""Core of the port: topologies (hierarchical ones too), their
time-varying schedules and elastic membership, the dense gossip backend
(overlapped rounds, the bf16 wire) and the sharded ones over
``torch.distributed``, LR schedules, PD-SGDM (paper
Algorithm 1), CPD-SGDM (Algorithm 2) with its compressors and wire codecs,
C-SGDM, the momentum-free baselines, and MT-DSGDm and QG-DSGDm for
non-IID data."""
from repro_torch.core import schedules, topology
from repro_torch.core.baselines import (CSGDM, choco_sgd, d_sgd,
                                        make_optimizer, pd_sgd)
from repro_torch.core.compression import (Compressor, IdentityCompressor,
                                          QSGDCompressor, RandKCompressor,
                                          SignCompressor,
                                          SparseRowsCompressor,
                                          TopKCompressor, make_compressor)
from repro_torch.core.cpdsgdm import CPDSGDM, CPDSGDMConfig
from repro_torch.core.gossip import (CommBackend, DenseComm,
                                     HierarchicalComm, ShardedComm,
                                     gossip_bytes_per_round)
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig
from repro_torch.core.topology import (MembershipSchedule, Topology,
                                       TopologySchedule, active_edge_count,
                                       complete, disconnected, exponential,
                                       full_membership, hierarchical,
                                       hierarchical_schedule, make_schedule,
                                       make_topology, masked_matrix,
                                       membership_from_events, ring, torus)
from repro_torch.core.tracking import (MTDSGDMConfig, MTDSGDm, QGDSGDMConfig,
                                       QGDSGDm)
from repro_torch.core.wire import (IdentityCodec, QSGDCodec, RandKCodec,
                                   SignCodec, SparseRowsCodec, TopKCodec,
                                   WireCodec, WireKey, make_codec, wire_key)

__all__ = [
    "topology", "schedules",
    "Topology", "TopologySchedule", "ring", "torus", "complete",
    "exponential", "disconnected", "hierarchical", "hierarchical_schedule",
    "make_topology", "make_schedule",
    "MembershipSchedule", "full_membership", "membership_from_events",
    "masked_matrix", "active_edge_count",
    "CommBackend", "DenseComm", "ShardedComm", "HierarchicalComm",
    "gossip_bytes_per_round",
    "PDSGDM", "PDSGDMConfig", "CPDSGDM", "CPDSGDMConfig",
    "MTDSGDm", "MTDSGDMConfig", "QGDSGDm", "QGDSGDMConfig",
    "make_optimizer", "CSGDM", "d_sgd", "pd_sgd", "choco_sgd",
    "Compressor", "IdentityCompressor", "SignCompressor", "TopKCompressor",
    "RandKCompressor", "QSGDCompressor", "SparseRowsCompressor",
    "make_compressor",
    "WireCodec", "IdentityCodec", "SignCodec", "TopKCodec", "RandKCodec",
    "QSGDCodec", "SparseRowsCodec", "WireKey", "make_codec", "wire_key",
]
