"""Config schema: model architecture, parallelism, optimizer, input shapes.

Port of ``src/repro/configs/base.py``: the same frozen dataclasses, field
for field and default for default, so ``dataclasses.asdict`` of a port
config holds the reference's.  Fields that only the TPU backend reads
(``remat``, ``fsdp_min_size``, ``kernel_interpret``, the sharding levers)
are kept as inert data.  ``ModelCfg`` has four fields of its own, for
DeepSeek-V2's expert layer (``PORT_ONLY``): an expert width other than
``d_ff``, shared experts, an expert layer that holds only some of the
experts it routes over, and top-k gates left un-normalised; at their
defaults a config is the reference's.  MLA takes a direct query where
``q_lora_rank`` is 0 or None.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.kernels import LANE

__all__ = ["LayerSpec", "ModelCfg", "ParallelCfg", "OptimCfg", "RunCfg",
           "PORT_ONLY"]


# ModelCfg's fields that the reference's ModelCfg lacks, at their defaults
# in every registered config
PORT_ONLY = {"moe_d_ff": None, "n_shared_experts": 0, "experts_held": None,
             "moe_norm_topk": True}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating block pattern."""
    mixer: str = "attn"      # "attn" | "mla" | "mamba"
    ffn: str = "dense"       # "dense" | "moe" | "dense+moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    arch_type: str                  # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparametric
    qkv_bias: bool = False
    window: Optional[int] = None    # sliding-window attention
    rope_theta: float = 10000.0
    gated_mlp: bool = True
    tie_embeddings: bool = False
    # --- block pattern (repeated n_layers / len(pattern) times)
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # --- MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1             # per-group dispatch (see moe.MoECfg)
    moe_d_ff: Optional[int] = None  # an expert's width (None: d_ff)
    n_shared_experts: int = 0       # experts every token passes through
    experts_held: Optional[int] = None  # routed experts held (None: all)
    moe_norm_topk: bool = True      # renormalise the top-k gates
    # --- MLA (minicpm3; deepseek-v2 with q_lora_rank 0 or None)
    use_mla: bool = False
    q_lora_rank: Optional[int] = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    # --- SSM (mamba2 / jamba)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # lower the group->head B/C expansion as broadcast instead of
    # gather/repeat (perf iteration; semantically identical)
    ssm_bcast_groups: bool = False
    # --- input modality
    input_mode: str = "tokens"      # tokens | embeds | vlm
    n_patches: int = 1024           # vlm patch-prefix length  # lint: allow
    # --- dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # --- citation for the assigned-architecture pool
    source: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def expert_d_ff(self) -> int:
        """An expert's width: ``moe_d_ff``, or ``d_ff`` where it is None."""
        return self.moe_d_ff or self.d_ff

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head): the
        matrices of every layer, an expert layer's router, its held
        experts and its shared ones; norms and biases are left out."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        gate = 3 if self.gated_mlp else 2
        total = v * d * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            n = self.n_repeats
            if spec.mixer == "attn":
                total += n * d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += n * self.n_heads * hd * d
            elif spec.mixer == "mla":
                qk = self.qk_nope_dim + self.qk_rope_dim
                q_lora = self.q_lora_rank or 0
                q = (d * q_lora + q_lora * self.n_heads * qk if q_lora
                     else d * self.n_heads * qk)
                total += n * (q + d * self.kv_lora_rank
                              + d * self.qk_rope_dim
                              + self.kv_lora_rank * self.n_heads
                              * (self.qk_nope_dim + self.v_head_dim)
                              + self.n_heads * self.v_head_dim * d)
            elif spec.mixer == "mamba":
                di = self.ssm_expand * d
                conv = di + 2 * self.ssm_state
                total += n * (d * (2 * di + 2 * self.ssm_state
                                   + di // self.ssm_headdim)
                              + 4 * conv + di * d)
            if spec.ffn in ("dense", "dense+moe"):
                total += n * d * f * gate
            if spec.ffn in ("moe", "dense+moe"):
                held = (self.n_experts if self.experts_held is None
                        else self.experts_held)
                total += n * (d * self.n_experts + (
                    held + self.n_shared_experts) * d * self.expert_d_ff
                    * gate)
        return total

    def active_params_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts, and every
        shared expert)."""
        if self.n_experts == 0:
            return self.params_count()
        dense_cfg = dataclasses.replace(
            self, n_experts=max(self.top_k, 1), experts_held=None,
            pattern=self.pattern)
        return dense_cfg.params_count()


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    """How an arch maps onto the mesh.

    profile "A": decentralized worker per ("pod","data") index, TP on model.
    profile "B": worker per pod; FSDP over data + TP over model inside.
    """
    profile: str = "A"
    topology: str = "ring"          # gossip graph between workers
    # Hierarchical two-level gossip: group the worker axis into nodes of
    # `node_size` (0 = flat gossip).  Each round averages exactly inside
    # every node (fast intra links) and gossips node means between node
    # leaders over `topology` on the slow links (ring/exponential/
    # complete inter graph).  On a ("pod","data") two-axis worker layout
    # node_size must equal the inner-axis size (the pod boundary is the
    # node boundary).
    node_size: int = 0
    # compress the hierarchical inter-node wire with a keyless WireCodec
    # ("none" | identity | sign | topk | qsgd); flat gossip ignores it
    inter_codec: str = "none"
    # time-varying gossip: "static" keeps `topology`; otherwise one of
    # one_peer_exp | alt_axes | random_matching | hier_one_peer
    # (see core.topology.make_schedule; hier_one_peer needs node_size > 0)
    topology_schedule: str = "static"
    schedule_rounds: int = 0        # random_matching cycle length (0 = max(2, ⌈log₂K⌉))
    schedule_seed: int = 0          # random_matching matchings are seeded
    remat: str = "full"             # none | full
    fsdp_min_size: int = 2 ** 16    # don't shard tiny leaves
    # --- perf-iteration levers (defaults = paper-faithful baseline) ---
    inner: str = "tp"               # profile A inner parallelism: tp | dp
    attn_ctx_shard: bool = False    # context-parallel attention core
    moe_token_shard: bool = False   # constrain MoE token/expert sharding


@dataclasses.dataclass(frozen=True)
class OptimCfg:
    # pd_sgdm | cpd_sgdm | mt_dsgdm | qg_dsgdm | c_sgdm | d_sgd | ...
    name: str = "pd_sgdm"
    eta: float = 0.1
    mu: float = 0.9
    p: int = 4
    gamma: float = 0.4
    weight_decay: float = 1e-4
    # mt_dsgdm only: ship the gradient-tracking correction c through the
    # named wire codec below (compressed tracking) instead of full
    # precision.  Off by default — MT's correction wire is f32 unless
    # explicitly opted in (`--track-compressed` in launch.train).
    track_compressed: bool = False
    # --- wire codec (cpd_sgdm / choco): which δ-contraction ships, and its
    # shape knobs.  Every named compressor has a first-class wire format
    # (repro.core.wire): sign → packed bits + scales, topk → (idx, val)
    # slots, randk → values only (indices key-derived), qsgd → uintN
    # levels + norms, sparse → (row index, row values) pairs of the
    # touched rows only (compose the inner value codec with sparse+sign /
    # sparse+qsgd).  Irrelevant knobs are ignored per operator.
    compressor: str = "sign"        # identity | sign | topk | randk | qsgd
    #                               # | sparse | sparse+sign | sparse+qsgd
    compressor_block: int = LANE    # sign/topk/qsgd/sparse row width
    compressor_fraction: float = 0.01   # topk / randk kept fraction
    compressor_levels: int = 7      # qsgd levels (7 -> 4-bit wire)
    compressor_rows: int = 64       # sparse: shipped-row budget per leaf
    # dtype of the uncompressed gossip payload (PD/MT/QG x wire and MT's
    # uncompressed c wire): "float32" | "bfloat16".  bf16 halves the
    # bytes on every wire the backend ships; the self term and the mixing
    # accumulation stay f32 (`bytes_per_comm_round` charges 2 B/elem).
    wire_dtype: str = "float32"
    # Pallas execution path: run the fused round on the flatten-once
    # (rows, 1024) kernel layout — momentum scan, gossip mix and CPD's
    # packed sign wire in one layout, flattened once per round.  The
    # recommended configuration on TPU (`--use-kernel` in launch.train);
    # off by default here because this container only has the interpret-
    # mode correctness harness.
    use_kernel: bool = False
    # force Pallas interpret mode on/off; None = auto (interpret off-TPU)
    kernel_interpret: Optional[bool] = None
    # Communication-hiding overlapped rounds (`--overlap` in launch.train):
    # the gossip payload of round r is exchanged during round r+1's local
    # scan and mixed one round late (one-round-stale delayed mixing), so
    # the interconnect transfer hides behind compute.  The in-flight
    # payload rides the optimizer state (DelayedMixState) and is
    # checkpointed — resume mid-overlap is bit-identical.  Unsupported
    # combos (CPD-SGDM on the sharded backend / with use_kernel, MT-DSGDm
    # compressed tracking, every-step baselines) raise at construction.
    overlap: bool = False


@dataclasses.dataclass(frozen=True)
class RunCfg:
    model: ModelCfg
    parallel: ParallelCfg = ParallelCfg()
    optim: OptimCfg = OptimCfg()
