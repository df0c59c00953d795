"""Core of the port: topologies, the dense gossip backend, LR schedules,
PD-SGDM (paper Algorithm 1), CPD-SGDM (Algorithm 2) with its compressors
and wire codecs, and the momentum-free baselines."""
from repro_torch.core import schedules, topology
from repro_torch.core.baselines import (choco_sgd, d_sgd, make_optimizer,
                                        pd_sgd)
from repro_torch.core.compression import (Compressor, IdentityCompressor,
                                          QSGDCompressor, RandKCompressor,
                                          SignCompressor,
                                          SparseRowsCompressor,
                                          TopKCompressor, make_compressor)
from repro_torch.core.cpdsgdm import CPDSGDM, CPDSGDMConfig
from repro_torch.core.gossip import (CommBackend, DenseComm,
                                     gossip_bytes_per_round)
from repro_torch.core.pdsgdm import PDSGDM, PDSGDMConfig
from repro_torch.core.topology import Topology, complete, ring, torus
from repro_torch.core.wire import (IdentityCodec, QSGDCodec, RandKCodec,
                                   SignCodec, SparseRowsCodec, TopKCodec,
                                   WireCodec, WireKey, make_codec, wire_key)

__all__ = [
    "topology", "schedules",
    "Topology", "ring", "torus", "complete",
    "CommBackend", "DenseComm", "gossip_bytes_per_round",
    "PDSGDM", "PDSGDMConfig", "CPDSGDM", "CPDSGDMConfig",
    "make_optimizer", "d_sgd", "pd_sgd", "choco_sgd",
    "Compressor", "IdentityCompressor", "SignCompressor", "TopKCompressor",
    "RandKCompressor", "QSGDCompressor", "SparseRowsCompressor",
    "make_compressor",
    "WireCodec", "IdentityCodec", "SignCodec", "TopKCodec", "RandKCodec",
    "QSGDCodec", "SparseRowsCodec", "WireKey", "make_codec", "wire_key",
]
