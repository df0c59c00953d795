#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # build, check, train, report
    python3 chip_smoke.py --profile    # also profile one round of each
                                       # path into the output directory
                                       # (profile_round), and the gather
                                       # over 8 rounds (gather_in_round),
                                       # where the training phase runs;
                                       # and 4 decode steps of each
                                       # served model (profile_decode)
    python3 chip_smoke.py --gather-variant parent=PATH   # also build the
                                       # row_gather.cu at PATH and check
                                       # and time it beside this one
    python3 chip_smoke.py --probe-gloo # only ask whether gloo's send/recv
                                       # take a CUDA tensor
    python3 chip_smoke.py --phases kernels,sharded_olmo1b_tp2
                                       # only the named phases (PHASES, in
                                       # the script's order), printing the
                                       # ones it skipped; the kernels line
                                       # needs "kernels" and "training"

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all at once) and then, with TF32 off for convolutions and
matmuls:

1. holds each kernel against its plain PyTorch version on the card, at the
   main path's shape and at a ragged one, bit for bit, and times the
   kernel, the plain version and (where one exists) the single PyTorch call
   that computes the same function; the codec kernels run at the
   ResNet-20 row counts and at ragged rows with their edge cases, QSGD at
   levels 1, 7 and 127, top-k at W = 2, 11, 103 and 128 (with a tie run
   straddling the W-th place, subnormals, ±inf, NaN, equal |x| and a
   scatter payload that repeats columns; plus the select's time on rows
   of equal |x|, and at W = 128 on random full rows and on rows built to
   be its worst case), the row gather and scatter at
   the embedding plan and at ragged rows, the gather also at its edge
   shapes (K = 1, 3, 8; S = 1, 5, 65; NaN, ±inf, −0.0, subnormals;
   repeated and out-of-range indices) and at S = 1,024; it prints the
   timing window's floor, and the gather's times by three methods
   (per-launch windows, back to back on cold rows, and with ``--profile``
   in the round) beside ``index_select`` and a contiguous copy of the same
   bytes; the gossip mix in both its designs: on the shifted views of
   the ring (8, 512, 1024) and exponential(16) (16, 512, 1024) cut at
   ResNet-20's 310 used rows, a 2 × 4 torus (one launch per axis) and a
   ragged ring, through ``PDSGDM._gossip_mat`` too, and on 1 … 9, 17 and
   33 distinct matrices (33 chains two launches) and MT's two tracking
   shapes (n = 2 with weights (1, λ), n = 3 with (1, 1, −1)), the
   overlapped round's landing (1, 1) and MT's drip (1, 1/p), and with the
   neighbour views read from a second matrix (the bf16 wire's round trip
   of the payload) on the ring, the torus and a ragged ring; its times:
   the ring's and exp16's gossip steps beside ``W @ x`` (the uncut mix,
   same bytes and operations) and the plain version, the ring's bf16 step
   and its launch beside them, n = 2 beside ``torch.add``, and n = 3;
   ``momentum_update`` in place (x' and m' written over x and m, the form
   PD-SGDM's round launches) bit for bit against the out-of-place launch
   and timed beside it; and, at the full-width paths' shapes, OLMo's
   (8, 250368, 1024), Mixtral's (2, 1449472, 1024), MiniCPM3's
   (8, 244992, 1024) and Mamba2's (8, 226560, 1024) f32 (7.4 to 11.9 GB a
   matrix, past 2³² bytes), ``momentum_update`` in both forms and the
   ring's gossip step, bit for bit in row blocks of each worker, timed
   over 5 launches beside the plain version and ``torch._fused_sgd_`` /
   ``W @ x``;
2. drives twenty-six paths through the port's entry points, each once, with
   every launch counter set to 0 just before and read just after:
   PD-SGDM, CPD-SGDM with the default sign compressor, with
   ``QSGDCompressor(levels=7)`` (γ = 0.4) and with Fig. 3's
   ``TopKCompressor(fraction=0.1)`` (γ = 0.2), C-SGDM (p = 1), PD-SGDM on
   ``exponential(16)`` (K = 16, 9 shifted views a round, one launch) and
   on the
   one-peer exponential schedule (period 3), MT-DSGDm with full-precision
   and with sign-compressed tracking and QG-DSGDm (η = 0.05, the step of
   ``benchmarks/noniid_sweep.py``), and under elastic membership
   (``DenseComm(ring(8), membership=membership_from_events(8, 3, ...))``:
   round 0 kills worker 3, round 1 also stalls worker 6, round 2 revives
   3) PD-SGDM, CPD-SGDM with the sign wire and MT-DSGDm with sign
   tracking (η = 0.05); with overlapped rounds (``overlap=True``) PD-SGDM,
   MT-DSGDm and QG-DSGDm (η = 0.05) on the ring and PD-SGDM under the
   churn script; PD-SGDM on ``DenseComm(ring(8), wire_dtype="bfloat16")``
   and on ``hierarchical(2, 4)`` (the factored two-level round on the
   matrix, no gossip launch); all through ``make_optimizer`` →
   ``SimTrainer.train`` on the kernel layout, ResNet-20 at width 16, K = 8
   workers on a ring where not said otherwise, batch 16 per worker,
   p = 4, η = 0.1, μ = 0.9, weight decay 1e-4, 14 steps (3 rounds and a
   2-step tail; C-SGDM 14 rounds); and CPD-SGDM with
   ``SparseRowsCompressor(max_rows=64)`` through ``CPDSGDM.round`` on a
   (65,536 × 64) f32 embedding table per worker, K = 4 on a ring, Zipf
   lookups of batch 64, p = 4, η = 0.05, γ = 0.4 (the reference's
   ``benchmarks/embedding_wire.py``), 3 rounds and a 2-step tail; and
   six language-model paths through ``make_model`` →
   ``make_optimizer`` → ``SimTrainer.train`` with ``lm_batch``:
   PD-SGDM on OLMo-1B's published widths (d_model 2048, 16 heads, d_ff
   8192, vocab 50,304, non-parametric LayerNorm, GELU) cut to one of its
   16 layers and f32 params, K = 8 on a ring, η = 0.25, μ = 0.9, p = 4,
   weight decay 1e-4, seq 256, batch 2 a worker
   (``examples/pretrain_decentralized.py``'s lm-100m settings); PD-SGDM
   at the same step on Mixtral-8x7B's expert block at its published
   widths (d_model 4096, 32 heads / 8 KV, d_ff 14336, 8 experts top-2,
   capacity factor 1.25), one of its 32 layers, vocab cut to 4,000, f32,
   K = 2 on ``ring(2)``; PD-SGDM at the same step on MiniCPM3-4B's MLA
   layer at its published widths (d_model 2560, 40 heads, q_lora 768,
   kv_lora 256, nope/rope 64/32, v_head 64, d_ff 6400), one of its 62
   layers, vocab cut to 36,724 of 73,448, f32, K = 8, seq 256, batch 2;
   and on Mamba2-1.3B's SSD mixer at its published widths (d_model 2048,
   d_inner 4096, 64 heads of headdim 64, d_state 128, chunk 256, vocab
   50,280), one of its 48 layers, f32, K = 8, seq 1,024 (four chunks),
   batch 1 (the cuts and their reasons at ``FULL_WIDTH``); each with its
   peak memory printed; and the quickstart's tiny LM (2
   layers, d_model 64) at η = 0.3 with PD-SGDM on ``hierarchical(2, 4)``
   and with CPD-SGDM's sign wire (γ = 0.4) on the ring;
3. holds one kernel-path round against one round of the plain path from
   the same init on the same batches, for each of the twenty-six (the
   one-peer path over its 3-round cycle, the churn and overlapped paths
   each round of theirs from the same start, 3 or 4 rounds so that every
   stale matrix lands; the full-width paths' two rounds one after the
   other, the start and the kernel round's result held on the host): for
   PD-SGDM, C-SGDM, MT-DSGDm and QG-DSGDm the tree round, for every
   CPD-SGDM wire the round through the per-leaf codec, which launches no
   codec kernel;
   the params, m, the tracking state and the in-flight payload; and
   profiles one kernel round of PD on the ring, on ``exp16`` and on the
   bf16 wire, MT and QG, and overlapped PD and MT: their gossip dispatches
   no ``aten::roll`` and no ``aten::constant_pad_nd``; and holds
   Mixtral's MoE layer at full width on one worker's 512 tokens against a
   plain per-expert formulation (``moe_layer_phase``: routing and drops
   exact, outputs at an f32 bar that bf16 misses); MiniCPM3's MLA layer on
   512 tokens against per-head K and V and
   ``F.scaled_dot_product_attention`` (``mla_layer_phase``) and Mamba2's
   mixer on 1,024 positions against the sequential scan
   (``ssd_layer_phase``), each at an f32 bar that bf16 misses;
4. runs Fig. 1, Fig. 2, Fig. 3 and the non-IID sweep's α = 0.1 claim at
   the reference's settings (ResNet-20 width 4, K = 8 ring, batch 16, the
   kernel layout, cuDNN deterministic): ``fig1_phase`` (C-SGDM and PD at
   p = 4, 8, 16, 90 steps), ``fig2_phase`` (PD at p = 4, 8, 16 and CPD
   sign-64 at p = 4 and 16, 60 steps: comm-MB), ``fig3_phase`` (five
   wires at 70 steps, and the bars of ``tests/test_system.py`` on CPD
   sign-64 at 150 steps against PD at 90) and ``noniid_phase`` (D-SGD,
   PD, QG and MT at p = 1, 2, 4 on Dirichlet(0.1) labels, 64 steps,
   judged by the global loss of the averaged model through the trainer's
   ``eval_fn``; at p = 4 MT again with overlapped rounds, for
   ``noniid/claim_p4_overlap``);
5. holds the claims of ``benchmarks/elastic_sweep.py`` (``elastic_phase``:
   PD, CPD sign, MT and QG at churn 0, 0.1 and 0.25 through
   ``repro_torch.testing.run_dense_chaos`` on the kernel layout: every
   round's masked matrix checked and its bytes equal to the byte oracle,
   each cell's MB equal to the committed ``BENCH_elastic.json``'s, the
   survivors bounded) and the equal-bytes claim of
   ``benchmarks/topology_sweep.py`` (``topology_phase``: the static ring
   at 96 steps against the one-peer schedule at 192, K = 16);
6. drives the sharded runtime (``ShardedComm``/``HierarchicalComm`` through
   ``build_train`` and ``ShardedTrainer``) in ranks it spawns on this card,
   each a process on ``cuda:0`` joined by a gloo group, whose wire goes
   through pinned host buffers (a rank that fails fails the script; the
   chosen phases of one world size share one spawn, ``spawn_shared``,
   their rank functions run in turn):
   ``sharded_olmo1b`` (PD-SGDM on OLMo-1B's widths, one layer, f32, K = 4
   ranks on a ring, seq 256, batch 2, two rounds: per rank p momentum and
   1 gossip launches a round and 2 × used rows × 4 KiB handed to
   ``isend``; round 0's gossip bit for bit the dense shifted step on the
   stacked matrices; each round within the kernel-round bar of
   ``DenseComm``'s from the same start; each rank's peak memory and
   s/round), ``sharded_resnet_pd`` (the ``pd_sgdm`` path in 8 ranks: the
   dense run's launches and bytes per rank, each round and the tail bit
   for bit the dense round from the same start with the gradients taken
   worker by worker), ``sharded_tinylm_hier_sign`` (the tiny LM on
   ``HierarchicalComm``, flat axis, hierarchical(2, 2), the sign inter
   codec: the codec kernels on every rank, the inter bytes on the leaders
   and the all-reduce bytes as ``hier_bytes_per_round`` has them, each
   round against the dense round with the plain codec),
   ``sharded_resume`` (checkpoints at steps 6 and 8 resumed in fresh ranks
   bit for bit, and step 8 restored into 6 ranks), and the codec paths,
   each rank keeping a copy of each neighbour's x̂ (``xhat_nbrs``):
   ``sharded_olmo1b_cpd_sign`` (CPD-SGDM with the sign codec at
   ``sharded_olmo1b``'s widths and step, γ = 0.4, 4 ranks, two rounds:
   per rank 4 momentum, 1 gossip, 1 ``sign_pack`` and 3 ``sign_unpack``
   launches and 66,097,152 B to ``isend`` a round; after each round every
   copy's bit checksums those of the x̂ it tracks; round 0 within the
   kernel-round bar of the sharded formula replayed on the stacked
   matrices, x̂ past it only at sign flips, counted; peak and s/round
   beside ``sharded_olmo1b``'s), ``sharded_resnet_cpd`` (8 ranks, 14
   steps, in one spawn: CPD sign, QSGD and top-10 %, MT sign and CPD sign
   under the churn script; launches and bytes per rank, the copies
   gathered and held bit for bit after every round, every round and the
   tail bit for bit the sharded formula replayed on the stacked workers,
   the churn path's within the bar) and ``sharded_embedding_cpd_sparse``
   (the (65,536 × 64) table from one draw, 4 ranks, the sparse-rows
   codec: the row gather and scatter on the sharded path, held the same
   way); the three print their wall together; ``sharded_olmo1b_tp2``
   (PD-SGDM on OLMo-1B's widths at 2 of 16 layers, f32, seq 2,048, batch
   1, K = 2 workers × a model axis of 2: each rank its tensor-parallel
   shards, 4 ranks; ``TP_ROUNDS`` rounds with ``remat="full"`` and as
   many with ``"none"``: per rank and round 4 momentum and 1 gossip launches
   on its own kernel plan and 613,416,960 B to ``isend``; each round
   within 4.8e-7 of the same round at a model axis of 1 from the same
   start; "full" against "none"; each rank's allocator and gradient
   peaks and s/round for both; then the same ranks under ``inner="dp"``,
   ``sharded_olmo1b_dp2``: batch 2 a worker, a sequence a rank, each
   rank the whole worker, 1,226,833,920 B to ``isend``, a worker's two
   ranks bit-identical after every round), ``pretrain_sweep_rows`` (the
   port's example, ``--quick``, 8 steps, 4 workers × a model axis of 2 =
   8 ranks, the flat ring and hierarchical(2, 2) with the bf16 inter
   wire: ``bytes_per_comm_round`` equal to ``BENCH_pretrain.json``'s
   ``train_flat``/``train_hier`` rows and ``claim_equal_loss``),
   ``sharded_qwen2_72b_fsdp`` (PD-SGDM on Qwen2-72B's widths under its
   own profile B, one layer, vocab 4,000, 2 pods × an FSDP axis of 2, 4
   ranks, one round: each rank's FSDP shards, 1,886,527,488 B to
   ``isend``) and ``sharded_mla_ssd_tp2`` (MiniCPM3-4B's MLA and
   Mamba2-1.3B's SSD, 2 layers each, split by heads over a model axis of
   2, two rounds each); the ``SPLIT`` paths hold their launches and
   bytes per rank and round and each round within 4.8e-7 of one rank per
   worker from the same start, and print each rank's peaks and s/round.
   The sharded LM paths run the reference's default ``remat="full"``;
7. serves (``serve_full_width``): ``repro_torch.serve.serving.generate``
   (one ``prefill_fast``, then one ``decode_step`` a token) on OLMo-1B
   (16 layers, batch 16, prompt 1,920, 128 new), MiniCPM3-4B (62 layers,
   MLA's compressed cache, batch 8, prompt 1,024, 64 new) and
   Mamba2-1.3B (48 layers, the SSM state, batch 16, prompt 1,792, 256
   new) whole, and Mixtral-8x7B's 2 of 32 layers (batch 2, prompt 4,352
   past its 4,096-slot window: the prompt cache rolled, decode wrapping
   the ring, the MoE on the step's tokens), at published widths in the
   configs' bf16, printing prefill ms, decode ms a token, tok/s, peak
   memory and cache bytes beside the card's name and power limit; then
   the same params in f32 at batch 2 (``SERVE_BAR``: each prefill and
   decode step's logits against ``Model.apply``'s, the greedy tokens
   against its argmax where its top-2 gap passes the bar; Mixtral's
   prefill against apply over the prompt, and its attention layer's ring
   step by step against ``attention_apply`` over 4,480 rows); and
   ``serve_sharded_olmo1b``: OLMo-1B whole in f32 through ``build_serve``
   on the serving mesh 2 ("data") × 2 ("model"), 4 gloo ranks, batch 4,
   prompt 512, 32 new: the tokens equal one rank's, the logits within
   the bar, the bytes handed to ``all_reduce`` a decode step (and at the
   prefill) equal to their count from the shapes, each rank's peak;
8. checks the round contract (``contracts``): the fast dense grid of
   ``python -m repro_torch.analysis.run`` on the card (each combination
   one warm and one checked round, the checked one under
   ``torch.cuda.set_sync_debug_mode("error")``: p steps, no host sync, no
   float64, no collective, the kernel layout flattened once, the schedule
   chosen on the device, the membership mask), printing ``ok`` or
   ``FAIL`` and the kernels each launched, and each of momentum, gossip,
   sign pack/unpack and row gather/scatter launched; then the dry run of
   ``sharded_olmo1b_tp2``'s config, one round on meta as rank 0 of a
   4-rank fake group in a process of its own
   (``repro_torch.launch.dryrun.meta_step``): its bytes a round to
   ``isend`` equal to rank 0's measured bytes in this call (or to its
   accounted ``bytes_per_comm_round`` where that phase did not run), and
   its predicted peak a rank printed beside the measured one.

Printed, in order: the card's ``nvidia-smi`` name and power limit, the build
time, the kernel phase, the training phase, the round parity, the MoE,
MLA and SSD layers, the four figure phases' and the elastic and topology
phases' rows, verdicts and wall seconds, the sharded phases' rows, the
serving rows, the contract rows, each phase's wall seconds, one JSON
line ``{"kernels": [...]}`` (``momentum_update`` with its in-place time,
and with ``gossip_mix`` a ``full_width`` row for each path of
``FULL_WIDTH``) and, last, ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; so does a machine without a CUDA device, and a copy of the
script outside a checkout (it imports the port from ``src/`` beside
itself).  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bytes/s and f32 (non-tensor-core) FLOP/s by card name, from NVIDIA's
# data sheets (dense, at the card's full power limit); first match wins.
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),           # SXM5, 80 GB HBM3
)

DEVICE = "cuda"
K, WIDTH, BATCH, P, STEPS = 8, 16, 16, 4, 14
HYPER = dict(eta=0.1, mu=0.9, p=P, weight_decay=1e-4)
GAMMA = 0.4
QSGD_LEVELS = 7             # the 4-bit QSGD wire of Fig. 3
TOPK_FRACTION, TOPK_GAMMA = 0.1, 0.2    # Fig. 3's cpd_sgdm_p4_top10pct
# the embedding table of benchmarks/embedding_wire.py, at its largest size
EMB_K, EMB_ROWS, EMB_DIM, EMB_BATCH, EMB_MAX_ROWS = 4, 65536, 64, 64, 64
EMB_HYPER = dict(eta=0.05, mu=0.9, p=P, gamma=0.4, weight_decay=0.0)
EXP_K = 16                  # exponential(16): 9 shifts on one axis
TORUS = (2, 4)              # a torus of K = 8: two axes, one launch each
ONE_PEER = "one_peer_exp"   # period 3 at K = 8
HIER = (2, 4)               # hierarchical(2, 4): 2 nodes of 4 workers
# MT-DSGDm and QG-DSGDm run at benchmarks/noniid_sweep.py's step: at 0.1
# MT's tracked direction diverges at p = 4
TRACK_ETA = 0.05
# Fig. 1 at the reference's settings (benchmarks/common.py, fig1_pdsgdm.py)
FIG1_K, FIG1_WIDTH, FIG1_BATCH, FIG1_STEPS = 8, 4, 16, 90
FIG1_RUNS = (("c_sgdm", 1), ("pd_sgdm", 4), ("pd_sgdm", 8), ("pd_sgdm", 16))
FIG2_STEPS, FIG2_TARGET = 60, 1.2          # benchmarks/fig2_comm_cost.py
FIG3_STEPS = 70                            # benchmarks/fig3_cpdsgdm.py
# tests/test_system.py:test_cpdsgdm_matches_pdsgdm_with_less_comm
FIG3_CPD_STEPS, FIG3_PD_STEPS = 150, 90
# benchmarks/noniid_sweep.py at its claim's skew
NONIID_ALPHA, NONIID_STEPS, NONIID_PS = 0.1, 64, (1, 2, 4)
# the LM paths: the quickstart's tiny LM (examples/quickstart.py) at its
# step, and four models at their published widths, f32 params and compute
# (the kernel layout is f32), at examples/pretrain_decentralized.py:86-88's
# PD-SGDM settings (FULL_HYPER), with the sequence and batch a worker of
# each path in its FULL_WIDTH entry:
# - OLMo-1B (configs/olmo_1b.py) cut to one of its 16 layers, K = 8, at the
#   example's lm-100m rows' sequence (256) and batch (2 a worker);
# - Mixtral-8x7B (configs/mixtral_8x7b.py: d_model 4096, 32 heads / 8 KV,
#   d_ff 14336, 8 experts top-2 at capacity factor 1.25 in one global sort,
#   window 4096, inert at seq 256, RMSNorm, untied head, gated SiLU), cut so
#   that it fits one card: K = 2 workers on ring(2), a pair average,
#   instead of 8, since the round's peak holds six copies of the K workers'
#   params, 11.06 GiB a copy at K = 2 (44 GiB at K = 8); 1 of its 32 layers,
#   one whole period of its (attn, moe) pattern (1.41 B params a layer a
#   worker); the vocabulary cut to 4,000, an eighth of its 32,000, the
#   share of one chip of a vocabulary split over 8 (the token ids are drawn
#   from that slice); f32 instead of its bf16; seq 256, batch 2;
# - MiniCPM3-4B (configs/minicpm3_4b.py: d_model 2560, 40 heads of MLA,
#   q_lora 768, kv_lora 256, nope/rope 64/32, v_head 64, d_ff 6400, gated
#   SiLU, RMSNorm), K = 8, seq 256, batch 2: 1 of its 62 layers, one whole
#   period of its (mla, dense) pattern; f32 instead of bf16; the vocabulary
#   cut to 36,724 of 73,448, the share of one chip of a vocabulary split
#   over two (ids drawn from it): the full one makes 438,731,264 params a
#   worker, 13.07 GiB a copy at K = 8, and six copies live at the grad
#   flatten would be 78.4 GiB before activations; cut, 250,704,384 params,
#   7.47 GiB a copy;
# - Mamba2-1.3B (configs/mamba2_1_3b.py: d_model 2048, d_inner 4096, 64 SSD
#   heads of headdim 64, d_state 128, conv 4, chunk 256, vocab 50,280), K = 8:
#   1 of its 48 layers; f32 instead of bf16; 231,798,208 params a worker,
#   6.91 GiB a copy; seq 1,024 at batch 1 a worker, so that the chunk
#   recurrence runs over four chunks of the published 256 (at seq 256 there
#   is one chunk, and the recurrence never runs)
TINY_LM = dict(name="tiny-lm", arch_type="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
TINY_SEQ, TINY_BATCH = 32, 4
TINY_HYPER = dict(eta=0.3, mu=0.9, p=P)
FULL_HYPER = dict(eta=0.25, mu=0.9, p=P, weight_decay=1e-4)
MIXTRAL_K = 2
# each full-width path: its architecture, the cuts, its sequence and batch
# a worker, the plan's rows and used rows of one worker's tree (the shape
# at which the full-width kernel phase holds the kernels), and how many
# workers' rows the plain momentum update is timed on (its four
# temporaries and two outputs beside x, m and g must fit the card: all 8
# of OLMo's, MiniCPM3's and Mamba2's, one of Mixtral's two)
FULL_WIDTH = {
    "pd_sgdm_olmo1b": dict(arch="olmo-1b", cuts=dict(n_layers=1), seq=256,
                           batch=2, rows=250_368, used=250_368,
                           plain_workers=8),
    "pd_sgdm_mixtral": dict(arch="mixtral-8x7b",
                            cuts=dict(n_layers=1, vocab=4000), seq=256,
                            batch=2, rows=1_449_472, used=1_449_260,
                            plain_workers=1),
    "pd_sgdm_minicpm3": dict(arch="minicpm3-4b",
                             cuts=dict(n_layers=1, vocab=36_724), seq=256,
                             batch=2, rows=244_992, used=244_831,
                             plain_workers=8),
    "pd_sgdm_mamba2": dict(arch="mamba2-1.3b", cuts=dict(n_layers=1),
                           seq=1024, batch=1, rows=226_560,  # lint: allow
                           used=226_369, plain_workers=8),
}
# the full-width paths whose momentum launch is also timed reading the
# gradient's leaves (:func:`leaf_launch`): the benchmark's two models
LEAF_PATHS = ("pd_sgdm_olmo1b", "pd_sgdm_mamba2")
# the row blocks of the full-width checks: an eighth of a Mixtral worker,
# so that the plain versions' temporaries and the int64 copies of
# ``max_ulp`` fit beside the operands
CHECK_ROWS = 181_184
# the churn paths' membership, period 3: round 0 kills worker 3, round 1
# also stalls worker 6, round 2 revives worker 3 (everyone exchanges)
CHURN_ROUNDS = 3
CHURN_EVENTS = ((0, "kill", 3), (1, "straggle", 6), (2, "revive", 3))
# benchmarks/elastic_sweep.py: K = 8 ring, a D = 64 quadratic, p = 2
ELASTIC_D, ELASTIC_P, ELASTIC_ROUNDS, ELASTIC_SEED = 64, 2, 16, 7
ELASTIC_RATES = (0.0, 0.1, 0.25)
# benchmarks/topology_sweep.py: K = 16, D = 64, PD at η = 0.2, p = 4; the
# static ring at S steps against the one-peer schedule at 2S
TOPO_K, TOPO_D, TOPO_ETA, TOPO_STEPS = 16, 64, 0.2, 96
# bytes per worker per round over one schedule cycle, on 310 used rows
# (ResNet-20), its 272,282 f32 on the tree wire, or the table's 4,096 rows
WIRE_BYTES = {"pd_sgdm": (2_539_520,),         # 2 × 310 × 1024 × 4 B
              "cpd_sgdm_sign": (81_840,),      # 2 × 310 × (128 + 4) B
              "cpd_sgdm_qsgd": (319_920,),     # 2 × 310 × (512 + 4) B
              "cpd_sgdm_topk": (510_880,),     # 2 × 310 × 103 × (4 + 4) B
              "cpd_sgdm_sparse": (524_800,),   # 2 × 64 × (4 + 4096) B
              "c_sgdm": (7_623_896,),          # 7 × 272,282 × 4 B
              "pd_sgdm_exp16": (10_158_080,),  # 8 × 310 × 1024 × 4 B
              "pd_sgdm_onepeer": (1_089_128,) * 3,   # 1 × 272,282 × 4 B
              "mt_dsgdm": (5_079_040,),        # 2 × 2 × 310 × 1024 × 4 B
              "mt_dsgdm_sign": (2_621_360,),   # x + 2 × 310 × (128 + 4) B
              "qg_dsgdm": (2_539_520,),        # x only, as PD
              # under churn: the tree wire × 1.5, 1 and 2 active edges a
              # worker (12, 8 and 16 of the ring's 16 exchanges)
              "pd_sgdm_churn": (1_633_692, 1_089_128, 2_178_256),
              # 81,840 B × 5/8, 2/8 and 8/8 committing workers
              "cpd_sgdm_sign_churn": (51_150, 20_460, 81_840),
              # (272,282 × 4 + 40,920 B) × 1.5, 1 and 2 active edges
              "mt_dsgdm_sign_churn": (1_695_072, 1_130_048, 2_260_096),
              # overlapped rounds: one payload exchange a round, as above
              "pd_sgdm_overlap": (2_539_520,),
              "mt_dsgdm_overlap": (5_079_040,),
              "qg_dsgdm_overlap": (2_539_520,),
              "pd_sgdm_overlap_churn": (1_633_692, 1_089_128, 2_178_256),
              # the bf16 wire: 2 × 310 × 1024 × 2 B
              "pd_sgdm_bf16": (1_269_760,),
              # hierarchical(2, 4): the inter level, 1 × 272,282 × 4 B over
              # the node size 4
              "pd_sgdm_hier": (272_282,),
              # OLMo-1B, one layer: 2 × 250,368 rows × 4 KiB, every leaf
              # filling whole rows (so the tree wire is the same)
              "pd_sgdm_olmo1b": (2_051_014_656,),
              # Mixtral-8x7B, one layer, K = 2 (one neighbour): 1 × 1,449,260
              # used rows × 4 KiB, every leaf a multiple of 1,024 elements
              # (1,484,042,240 params × 4 B, the tree wire too)
              "pd_sgdm_mixtral": (5_936_168_960,),
              # MiniCPM3-4B, one layer, vocab 36,724: 2 × 244,831 used rows
              # × 4 KiB (the norm scales fill part rows)
              "pd_sgdm_minicpm3": (2_005_655_552,),
              # Mamba2-1.3B, one layer: 2 × 226,369 used rows × 4 KiB
              # (conv_b, A_log, dt_bias and D fill part rows)
              "pd_sgdm_mamba2": (1_854_414_848,),
              # the tiny LM's 106,816 f32 × 4 B over the node size 4
              "pd_sgdm_tinylm_hier": (106_816,),
              # 2 × 107 used rows × (128 + 4) B
              "cpd_sgdm_tinylm_sign": (28_248,)}
# the lines of nvcc's -Xptxas -v output that are printed: each kernel's
# name, then its registers, shared memory and spills
PTXAS_WORDS = ("Function properties", "registers", "spill")
SPIN_CYCLES = 2_000_000     # about 1 ms at the H100's 1.98 GHz boost clock
# the TPU kernel each CUDA kernel replaces (pl.pallas_call line) and its source
SOURCES = {"momentum_update": ("momentum.cu", "momentum.py:56"),
           "gossip_mix": ("gossip_mix.cu", "gossip_mix.py:43"),
           "sign_pack": ("sign_compress.cu", "sign_compress.py:81"),
           "sign_unpack": ("sign_compress.cu", "sign_compress.py:102"),
           "qsgd_quant": ("qsgd_quant.cu", "qsgd_quant.py:86"),
           "qsgd_dequant": ("qsgd_quant.cu", "qsgd_quant.py:109"),
           "topk_select": ("topk_select.cu", "topk_select.py:95"),
           "topk_scatter": ("topk_select.cu", "topk_select.py:117"),
           "row_gather": ("row_gather.cu", "row_gather.py:88"),
           "row_scatter": ("row_gather.cu", "row_gather.py:116")}


def peaks(name: str):
    for key, bw, f32 in PEAKS:
        if key in name:
            return bw, f32
    raise RuntimeError(f"no HBM/f32 peak on record for {name!r}")


def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own CUDA events.  A spin kernel of about 1 ms runs ahead of each pair, so
    the device is still busy while the host enqueues the events and ``fn``'s
    launches: the interval holds device time, not launch overhead.  The L2
    cache is not flushed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_ulp(torch, a, b) -> int:
    """Largest distance between two f32 tensors in units in the last place."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def kernel_phase(torch, ops, bw, f32_peak):
    """Each kernel against its plain version, bit for bit, and its times:
    the momentum update here, the gossip mix in :func:`gossip_kernel_phase`."""
    from repro_torch.kernels.momentum import momentum_update
    from repro_torch.kernels.ref import momentum_update_ref
    LANE = ops.LANE
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1234)
    mu, wd = HYPER["mu"], HYPER["weight_decay"]
    lr = torch.full((), HYPER["eta"], dtype=torch.float32, device=dev)
    main_rows = K * 512                  # (K, rows, 1024) folded onto rows
    results = {}
    for rows in (main_rows, 333):
        x, m, g = (torch.randn((rows, LANE), generator=gen, device=dev)
                   for _ in range(3))
        for nesterov in (False, True):
            got = momentum_update(x, m, g, lr, mu=mu, wd=wd, nesterov=nesterov)
            want = momentum_update_ref(x, m, g, lr, mu=mu, wd=wd,
                                       nesterov=nesterov)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ulp = max(max_ulp(torch, a, b) for a, b in zip(got, want))
            print(f"kernel momentum_update rows={rows} nesterov={nesterov}: "
                  f"max_abs_err={err} max_ulp={ulp}")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("momentum_update differs from its plain "
                                     f"version at rows={rows}")
            r = results.setdefault("momentum_update", [0.0, 0])
            r[0], r[1] = max(r[0], err), max(r[1], ulp)
            # the in-place launch, on copies, against the out-of-place one
            xi, mi = x.clone(), m.clone()
            momentum_update(xi, mi, g, lr, mu=mu, wd=wd, nesterov=nesterov,
                            inplace=True)
            same_bits(torch, "momentum_update", (xi, mi), got, results,
                      f"in place, rows={rows} nesterov={nesterov}")
            print(f"kernel momentum_update rows={rows} nesterov={nesterov} "
                  f"in place: bit for bit the out-of-place launch")

    # times at the main path's shape and configuration
    x, m, g = (torch.randn((main_rows, LANE), generator=gen, device=dev)
               for _ in range(3))
    n = x.numel()
    xs, ms, gs = x.clone(), m.clone(), g.clone()
    xi, mi = x.clone(), m.clone()
    timings = {
        "momentum_update": dict(
            ms=time_ms(torch, lambda: momentum_update(x, m, g, lr, mu=mu,
                                                      wd=wd)),
            # the form PD-SGDM's round launches: x' and m' over x and m
            inplace_ms=time_ms(torch, lambda: momentum_update(
                xi, mi, g, lr, mu=mu, wd=wd, inplace=True)),
            plain_ms=time_ms(torch, lambda: momentum_update_ref(x, m, g, lr,
                                                                mu=mu, wd=wd)),
            # the op behind torch.optim.SGD(fused=True): same update, in place
            library_ms=time_ms(torch, lambda: torch._fused_sgd_(
                [xs], [gs], [ms], weight_decay=wd, momentum=mu,
                lr=HYPER["eta"], dampening=0.0, nesterov=False,
                maximize=False, is_first_step=False)),
            bytes=5 * 4 * n, flops=6 * n),
    }
    finish_timings(timings, results, bw, f32_peak, (main_rows, LANE))
    print(f"kernel momentum_update ({main_rows}, {LANE}) in place: "
          f"{timings['momentum_update']['inplace_ms']:.5f} ms")
    del x, m, g, xs, ms, gs, xi, mi
    timings.update(gossip_kernel_phase(torch, ops, bw, f32_peak))
    return timings


def full_width_kernel_phase(torch, ops, bw, f32_peak, path: str) -> dict:
    """``momentum_update`` in both forms and the ring's gossip step at a
    full-width path's shape, (K, rows, 1024) f32: OLMo's (8, 250368, 1024),
    8.2 GB a matrix, Mixtral's (2, 1449472, 1024), 11.9 GB, MiniCPM3's
    (8, 244992, 1024) and Mamba2's (8, 226560, 1024), all past 2³² bytes.  The out-of-place launch is held bit for bit against its
    plain version and the in-place launch against the out-of-place one,
    and the gossip step against its plain version, in row blocks of each
    worker (``CHECK_ROWS``); then both forms are timed over 5
    launches in the per-launch window beside the plain version (on
    ``plain_workers`` workers' rows) and the library call
    (``torch._fused_sgd_``, in place, last); the gossip step beside
    ``W @ x.reshape(K, -1)``.  Returns each kernel's row for the JSON
    line's ``full_width``."""
    from repro_torch.kernels.momentum import momentum_update
    from repro_torch.kernels.ref import gossip_mix_ref, momentum_update_ref
    LANE = ops.LANE
    gc.collect()
    torch.cuda.empty_cache()
    opt = make_opt(path, use_kernel=True)
    k = WORKERS.get(path, K)
    plan = ops.KernelPlan.for_tree(
        {n: torch.empty((k,) + shape, device="meta")
         for n, shape in lm_model(path).param_shapes().items()},
        worker_dim=True)
    rows = plan.rows
    want = (FULL_WIDTH[path]["rows"], FULL_WIDTH[path]["used"])
    if (rows, plan.used_rows) != want:
        raise AssertionError(f"{path} plan: {rows} rows, {plan.used_rows} "
                             f"used, expected {want}")
    shape = (k, rows, LANE)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)
    mu, wd = FULL_HYPER["mu"], FULL_HYPER["weight_decay"]
    lr = torch.full((), FULL_HYPER["eta"], dtype=torch.float32, device=dev)
    x, m, g = (torch.randn((k * rows, LANE), generator=gen, device=dev)
               for _ in range(3))
    n = x.numel()
    blocks = [(w, slice(r, min(r + CHECK_ROWS, rows)))
              for w in range(k) for r in range(0, rows, CHECK_ROWS)]

    def rows_of(w, sl):
        return slice(w * rows + sl.start, w * rows + sl.stop)

    results, out = {}, {}
    xo, mo = momentum_update(x, m, g, lr, mu=mu, wd=wd)
    for w, sl in blocks:
        r = rows_of(w, sl)
        same_bits(torch, "momentum_update", (xo[r], mo[r]),
                  momentum_update_ref(x[r], m[r], g[r], lr, mu=mu, wd=wd),
                  results, f"{path} full width, worker {w} rows {sl.start}:"
                  f"{sl.stop}")
    momentum_update(x, m, g, lr, mu=mu, wd=wd, inplace=True)
    for w, sl in blocks:
        r = rows_of(w, sl)
        same_bits(torch, "momentum_update", (x[r], m[r]), (xo[r], mo[r]),
                  results, f"{path} full width in place, worker {w} rows "
                  f"{sl.start}:{sl.stop}")
    print(f"kernel momentum_update {path} {shape}: in place and out of "
          f"place bit for bit equal, and to the plain version, in "
          f"{len(blocks)} row blocks")
    del xo, mo
    pw = FULL_WIDTH[path]["plain_workers"] * rows
    timing = dict(
        ms=time_ms(torch, lambda: momentum_update(x, m, g, lr, mu=mu, wd=wd),
                   reps=5, warmup=1),
        inplace_ms=time_ms(torch, lambda: momentum_update(
            x, m, g, lr, mu=mu, wd=wd, inplace=True), reps=5, warmup=1),
        plain_ms=time_ms(torch, lambda: momentum_update_ref(
            x[:pw], m[:pw], g[:pw], lr, mu=mu, wd=wd), reps=5, warmup=1),
        plain_rows=pw,
        library_ms=time_ms(torch, lambda: torch._fused_sgd_(
            [x], [g], [m], weight_decay=wd, momentum=mu,
            lr=FULL_HYPER["eta"], dampening=0.0, nesterov=False,
            maximize=False, is_first_step=False), reps=5, warmup=1),
        bytes=5 * 4 * n, flops=6 * n)
    finish_timings({"momentum_update": timing}, results, bw, f32_peak,
                   (path, "full width") + shape)
    print(f"kernel momentum_update {path} in place: {timing['inplace_ms']:.5f}"
          f" ms against {timing['ms']:.5f} out of place (bound "
          f"{timing['bound_ms']:.5f}); plain version on {pw} rows")
    out["momentum_update"] = timing
    del g
    if path in LEAF_PATHS:
        timing.update(leaf_launch(torch, ops, plan, x, m, lr, gen, path))
    del m
    x = x.view(shape)
    x[:, plan.used_rows:] = 0.0     # the plan's zero tail past the wire
    top = opt.comm.topology
    before = counters()["gossip_mix"].launches
    y = opt._gossip_mat(x, 0, plan=plan)
    if counters()["gossip_mix"].launches - before != 1:
        raise AssertionError(f"{path} gossip step: not one launch")
    for w, sl in blocks:
        views = [x[(w + sh) % k, sl] for (_ax, sh, _wt) in top.shifts]
        same_bits(torch, "gossip_mix", (y[w, sl],), (gossip_mix_ref(
            views, [wt for (_ax, _sh, wt) in top.shifts]),), results,
            f"{path} full width ring, worker {w} rows {sl.start}:{sl.stop}")
    del y
    W = opt.comm._W
    timing = dict(
        ms=time_ms(torch, lambda: opt._gossip_mat(x, 0, plan=plan), reps=5,
                   warmup=1),
        plain_ms=time_ms(torch, lambda: plain_gossip(top, x,
                                                     plan.used_rows),
                         reps=5, warmup=1),
        library_ms=time_ms(torch, lambda: W @ x.reshape(k, -1), reps=5,
                           warmup=1),
        bytes=2 * 4 * n, flops=(2 * len(top.shifts) - 1) * n)
    finish_timings({"gossip_mix": timing}, results, bw, f32_peak,
                   (path, "full width ring step") + shape)
    out["gossip_mix"] = timing
    del x
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("ms", "inplace_ms", "leaves_ms", "flatten_ms", "plain_ms",
            "plain_rows", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    return {name: dict({key: t[key] for key in keys if key in t},
                       path=path, shape=list(shape))
            for name, t in out.items()}


def leaf_launch(torch, ops, plan, x, m, lr, gen, path: str) -> dict:
    """PD-SGDM's local step at a full-width path's shape: the in-place
    launch that reads the gradient's leaves where they lie
    (``ops.Leaves``), held bit for bit against flattening them and the
    matrix launch, with one launch and every leaf read in place
    (``leaf_copies`` 0); then timed beside the flatten it replaces, over
    5 launches.  ``x`` and ``m`` are the ``(K·rows, 1024)`` operands,
    updated in place."""
    from repro_torch.kernels.momentum import momentum_update
    mu, wd = FULL_HYPER["mu"], FULL_HYPER["weight_decay"]
    k = x.shape[0] // plan.rows
    shapes = lm_model(path).param_shapes()
    tree = {n: torch.randn((k,) + tuple(shapes[n]), generator=gen,
                           device=x.device) for n in plan.names}
    g = plan.flatten(tree)
    xm, mm = x.clone(), m.clone()
    ops.momentum_update_mat(xm, mm, g, mu=mu, lr=lr, weight_decay=wd,
                            inplace=True)
    del g
    before = (momentum_update.launches, momentum_update.leaf_reads,
              momentum_update.leaf_copies)
    ops.momentum_update_mat(x.view(k, plan.rows, -1), m.view(k, plan.rows, -1),
                            ops.Leaves(plan, tree), mu=mu, lr=lr,
                            weight_decay=wd, inplace=True)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(
        (momentum_update.launches, momentum_update.leaf_reads,
         momentum_update.leaf_copies), before))
    if counts != (1, len(plan.names), 0):
        raise AssertionError(f"{path} leaf launch: (launches, leaf reads, "
                             f"leaf copies) {counts}")
    if not (torch.equal(x, xm) and torch.equal(m, mm)):
        raise AssertionError(f"{path} leaf launch differs from the flatten "
                             "and the matrix launch")
    del xm, mm
    xs, ms = x.view(k, plan.rows, -1), m.view(k, plan.rows, -1)
    out = dict(
        leaves_ms=time_ms(torch, lambda: ops.momentum_update_mat(
            xs, ms, ops.Leaves(plan, tree), mu=mu, lr=lr, weight_decay=wd,
            inplace=True), reps=5, warmup=1),
        flatten_ms=time_ms(torch, lambda: plan.flatten(tree), reps=5,
                           warmup=1))
    print(f"kernel momentum_update {path} in place on the gradient's "
          f"{len(plan.names)} leaves: bit for bit the flatten and the matrix "
          f"launch, 1 launch, 0 leaf copies; {out['leaves_ms']:.5f} ms, the "
          f"flatten it replaces {out['flatten_ms']:.5f} ms")
    return out


def turns(torch, fns: dict) -> dict:
    """Each of ``fns`` timed by :func:`time_ms` in two turns, in order and
    then in reverse (A B … B A); the mean of its two medians."""
    got = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            got[name].append(time_ms(torch, fns[name]))
    return {name: statistics.mean(v) for name, v in got.items()}


def gossip_step_setup(torch, ops, path: str, top=None, wire="float32"):
    """The optimizer of ``path`` (or PD-SGDM on ``top`` over the ``wire``
    dtype), the kernel plan of ResNet-20 width 16 over its workers, and a
    random kernel matrix of that plan: what ``PDSGDM._gossip_mat`` takes
    in the round."""
    if top is None:
        opt = make_opt(path, use_kernel=True)
    else:
        from repro_torch.core import DenseComm, make_optimizer
        opt = make_optimizer("pd_sgdm", DenseComm(top, wire_dtype=wire,
                                                  device=DEVICE),
                             use_kernel=True, **HYPER)
    params = stacked_init(torch, 3, opt.comm.topology.n_workers)
    plan = ops.KernelPlan.for_tree(params, worker_dim=True)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = plan.flatten({n: torch.randn(v.shape, generator=gen, device=DEVICE)
                      for n, v in params.items()})
    return opt, plan, x


def plain_gossip(top, x, lim, bf16=False):
    """The plain gossip of a shift graph on the kernel layout: per axis,
    the wire cut, the worker-grid roll, the re-pad and the left-to-right
    sum (``ref.gossip_shift_ref``); with ``bf16`` the neighbour views read
    the bf16 round trip of the axis's payload."""
    from repro_torch.core.gossip import bf16_round_trip
    from repro_torch.kernels.ref import gossip_shift_ref
    per_axis: dict = {}
    for (ax, sh, w) in top.shifts:
        per_axis.setdefault(ax, []).append((sh, w))
    for ax in sorted(per_axis):
        shifts, ws = zip(*per_axis[ax])
        x = gossip_shift_ref(x, shifts, ws, grid=top.axis_sizes, axis=ax,
                             lim=lim, nbr=bf16_round_trip(x) if bf16
                             else None)
    return x


def gossip_kernel_phase(torch, ops, bw, f32_peak) -> dict:
    """The gossip mix against its plain version, bit for bit, and its
    times.

    Shift graphs (one launch per axis, the views read in place), in the
    tile design the kernel picks and in the stream design forced: the ring
    (8, 512, 1024) and a 2 × 4 torus at ResNet-20's 310 used rows,
    exponential(16) (16, 512, 1024) with 9 views, and a ragged
    (8, 333, 1024) ring cut at 201 rows; and ``PDSGDM._gossip_mat`` on the
    ring, ``exp16`` and the torus with the real plan.  Distinct matrices:
    n = 1 … 9, 17 and 33 on 333 rows (33 chains two launches), MT's
    (1, λ) and (1, 1, −1) on (4096, 1024) and 333 rows, the overlapped
    round's landing (1, 1) and MT's drip (1, 1/p).  The bf16 wire: the
    shifted mix with its neighbour views read from a second matrix (the
    payload's bf16 round trip, ``nbr``) on the ring, the torus and the
    ragged ring, and ``_gossip_mat`` of ``DenseComm(ring(8),
    wire_dtype="bfloat16")``.  Times, in the same window in two turns: the
    ring and ``exp16`` steps in both designs beside their plain version and
    ``W @ x``, and the ring's bf16 step and its kernel launch (``nbr``
    given) beside them; n = 2 beside ``torch.add``; n = 3."""
    from repro_torch.core import exponential, ring, torus
    from repro_torch.core.gossip import bf16_round_trip
    from repro_torch.kernels.gossip_mix import (gossip_mix,
                                                gossip_mix_shifted,
                                                launch_count)
    from repro_torch.kernels.ref import gossip_mix_ref, gossip_shift_ref
    LANE = ops.LANE
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2468)
    wd = HYPER["weight_decay"]
    results = {}
    _, plan, _ = gossip_step_setup(torch, ops, "pd_sgdm")
    used, rows = plan.used_rows, plan.rows
    designs = {"tile": False, "stream": True}     # name: _force_stream
    for label, top, n_rows, lim in (
            ("ring", ring(K), rows, used),
            ("exp16", exponential(EXP_K), rows, used),
            ("torus", torus(TORUS), rows, used),
            ("ring ragged", ring(K), 333, 201)):
        x = torch.randn((top.n_workers, n_rows, LANE), generator=gen,
                        device=dev)
        x[0, lim, :8] = -0.0    # −0.0 in the self view, padded neighbours
        per_axis: dict = {}
        for (ax, sh, w) in top.shifts:
            per_axis.setdefault(ax, []).append((sh, w))
        want = plain_gossip(top, x, lim)
        for design, force in designs.items():
            before = gossip_mix.launches
            y = x
            for ax in sorted(per_axis):
                shifts, ws = zip(*per_axis[ax])
                y = gossip_mix_shifted(y, grid=top.axis_sizes, axis=ax,
                                       shifts=shifts, weights=ws, lim=lim,
                                       _force_stream=force)
            same_bits(torch, "gossip_mix", (y,), (want,), results,
                      f"{label}, design {design}")
            if gossip_mix.launches - before != len(per_axis):
                raise AssertionError(f"gossip_mix {label}: "
                                     f"{gossip_mix.launches - before} "
                                     f"launches for {len(per_axis)} axes")
        print(f"kernel gossip_mix {label} {tuple(x.shape)} lim={lim}, "
              f"{len(top.shifts)} views on {len(per_axis)} axes: bit-exact "
              f"in designs {', '.join(designs)}, one launch per axis")
    # the bf16 wire: views of two matrices, the self view from x and the
    # neighbour views from nbr, the f32 round trip of the bf16 payload
    for label, top, n_rows, lim in (("ring", ring(K), rows, used),
                                    ("torus", torus(TORUS), rows, used),
                                    ("ring ragged", ring(K), 333, 201)):
        x = torch.randn((top.n_workers, n_rows, LANE), generator=gen,
                        device=dev)
        x[0, lim, :8] = -0.0
        per_axis: dict = {}
        for (ax, sh, w) in top.shifts:
            per_axis.setdefault(ax, []).append((sh, w))
        before = gossip_mix.launches
        y = x
        for ax in sorted(per_axis):
            shifts, ws = zip(*per_axis[ax])
            y = gossip_mix_shifted(y, grid=top.axis_sizes, axis=ax,
                                   shifts=shifts, weights=ws, lim=lim,
                                   nbr=bf16_round_trip(y))
        same_bits(torch, "gossip_mix", (y,),
                  (plain_gossip(top, x, lim, bf16=True),), results,
                  f"{label}, bf16 neighbours")
        if gossip_mix.launches - before != len(per_axis):
            raise AssertionError(f"gossip_mix {label} bf16: "
                                 f"{gossip_mix.launches - before} launches")
    for label, top in (("ring", None), ("torus", torus(TORUS))):
        opt, plan, x = gossip_step_setup(torch, ops, "pd_sgdm_bf16", top,
                                         wire="bfloat16")
        same_bits(torch, "gossip_mix", (opt._gossip_mat(x, 0, plan=plan),),
                  (plain_gossip(opt.comm.topology, x, plan.used_rows,
                                bf16=True),), results, f"{label} bf16 step")
    print("kernel gossip_mix ring, torus and ragged ring with the "
          "neighbour views from the bf16 round trip (stream design), and "
          "the bf16 steps (_gossip_mat): bit-exact, one launch per axis")
    for label, path, top in (("ring", "pd_sgdm", None),
                             ("exp16", "pd_sgdm_exp16", None),
                             ("torus", None, torus(TORUS))):
        opt, plan, x = gossip_step_setup(torch, ops, path, top)
        top = opt.comm.topology
        before = gossip_mix.launches
        y = opt._gossip_mat(x, 0, plan=plan)
        launches = gossip_mix.launches - before
        same_bits(torch, "gossip_mix", (y,),
                  (plain_gossip(top, x, plan.used_rows),), results,
                  f"{label} step")
        axes = len({ax for (ax, _, _) in top.shifts})
        if launches != axes:
            raise AssertionError(f"{label} step: {launches} launches")
        print(f"kernel gossip_mix {label} step (_gossip_mat, "
              f"{tuple(x.shape)}, used_rows={plan.used_rows}): bit-exact, "
              f"{launches} launches")
    xs = [torch.randn((333, LANE), generator=gen, device=dev)
          for _ in range(33)]
    for n in (1, 2, 3, 4, 5, 6, 7, 8, 9, 17, 33):
        ws = tuple(0.01 + 0.005 * j for j in range(n))
        before = gossip_mix.launches
        y = gossip_mix(xs[:n], weights=ws)
        same_bits(torch, "gossip_mix", (y,), (gossip_mix_ref(xs[:n], ws),),
                  results, f"n={n}")
        if gossip_mix.launches - before != launch_count(n):
            raise AssertionError(f"gossip_mix n={n}: "
                                 f"{gossip_mix.launches - before} launches")
    print(f"kernel gossip_mix rows=333 n=1..9,17,33 (launches "
          f"{[launch_count(n) for n in (9, 17, 33)]} at 9, 17, 33): "
          f"bit-exact")
    del xs
    # MT's tracking AXPYs: ĝ = 1·g + λ·x and c + ĝ − ĝ_prev; the
    # overlapped round's landing x + dx and MT's drip c + dc/p
    track_w = ((1.0, wd), (1.0, 1.0, -1.0), (1.0, 1.0), (1.0, 1.0 / P))
    main_rows = K * 512
    for n_rows in (main_rows, 333):
        for ws in track_w:
            ins = [torch.randn((n_rows, LANE), generator=gen, device=dev)
                   for _ in ws]
            same_bits(torch, "gossip_mix", (gossip_mix(ins, weights=ws),),
                      (gossip_mix_ref(ins, ws),), results,
                      f"weights {ws}, rows={n_rows}")
    print(f"kernel gossip_mix rows={main_rows},333 weights {track_w}: "
          f"bit-exact")

    # the two gossip steps as the round runs them, each design's launch,
    # the plain composition and W @ x (the uncut mix: a proxy with the
    # same bytes and operations); bound: x read once, y written once
    timings = {}
    for path in ("pd_sgdm", "pd_sgdm_exp16"):
        opt, plan, x = gossip_step_setup(torch, ops, path)
        top = opt.comm.topology
        shifts, ws = zip(*[(sh, w) for (_ax, sh, w) in top.shifts])
        k, W, lim = x.shape[0], opt.comm._W, plan.used_rows
        fns = {"step": lambda: opt._gossip_mat(x, 0, plan=plan)}
        for d, force in designs.items():
            fns[d] = (lambda force=force: gossip_mix_shifted(
                x, grid=top.axis_sizes, axis=0, shifts=shifts, weights=ws,
                lim=lim, _force_stream=force))
        fns["plain"] = lambda: gossip_shift_ref(x, shifts, ws,
                                                grid=top.axis_sizes, axis=0,
                                                lim=lim)
        fns["W @ x"] = lambda: W @ x.reshape(k, -1)
        if path == "pd_sgdm":
            # the bf16 wire: the step (the round trip, then the launch)
            # and the launch alone on a given nbr
            bopt = make_opt("pd_sgdm_bf16", use_kernel=True)
            nbr = bf16_round_trip(x)
            fns["bf16 step"] = lambda: bopt._gossip_mat(x, 0, plan=plan)
            fns["bf16 kernel"] = lambda: gossip_mix_shifted(
                x, grid=top.axis_sizes, axis=0, shifts=shifts, weights=ws,
                lim=lim, nbr=nbr)
        t = turns(torch, fns)
        print(f"kernel gossip_mix {path} step {tuple(x.shape)}, "
              f"{len(shifts)} views, used_rows={lim}, ms: "
              + ", ".join(f"{d} {t[d]:.5f}" for d in fns))
        timings[path] = dict(ms=t["step"], plain_ms=t["plain"],
                             library_ms=t["W @ x"], bytes=2 * 4 * x.numel(),
                             flops=(2 * len(shifts) - 1) * x.numel())
        finish_timings({"gossip_mix": timings[path]}, results, bw, f32_peak,
                       (path,) + tuple(x.shape))
        if path == "pd_sgdm":
            # the launch on the bf16 wire reads x, the used rows of nbr and
            # writes y; the step as a function reads x and writes y
            finish_timings({"gossip_mix": dict(
                ms=t["bf16 kernel"], plain_ms=t["plain"], library_ms=None,
                bytes=4 * (2 * x.numel() + k * lim * LANE),
                flops=(2 * len(shifts) - 1) * x.numel())}, results, bw,
                f32_peak, ("bf16 kernel", "nbr") + tuple(x.shape))
            finish_timings({"gossip_mix": dict(
                ms=t["bf16 step"], plain_ms=t["plain"], library_ms=None,
                bytes=2 * 4 * x.numel(),
                flops=(2 * len(shifts) - 1) * x.numel())}, results, bw,
                f32_peak, ("bf16 step",) + tuple(x.shape))
    # MT's two tracking launches on (4096, 1024): n = 2 reads 2 and writes
    # 1 an element, beside torch.add(g, x, alpha=λ), the same function;
    # n = 3 reads 3
    g, x, m = (torch.randn((main_rows, LANE), generator=gen, device=dev)
               for _ in range(3))
    for ws, library in (((1.0, wd), lambda: torch.add(g, x, alpha=wd)),
                        ((1.0, 1.0, -1.0), None)):
        ins = [g, x, m][:len(ws)]
        fns = {"kernel": lambda: gossip_mix(ins, weights=ws),
               "plain": lambda: gossip_mix_ref(ins, ws)}
        if library is not None:
            fns["torch.add"] = library
        t = turns(torch, fns)
        print(f"kernel gossip_mix ({main_rows}, {LANE}) n={len(ws)} weights "
              f"{ws}, ms: " + ", ".join(f"{d} {t[d]:.5f}" for d in fns))
        finish_timings({"gossip_mix": dict(
            ms=t["kernel"], plain_ms=t["plain"],
            library_ms=t.get("torch.add"),
            bytes=(len(ws) + 1) * 4 * x.numel(),
            flops=(2 * len(ws) - 1) * x.numel())}, results, bw, f32_peak,
            (main_rows, LANE, "n", len(ws)))
    return {"gossip_mix": timings["pd_sgdm"]}


def finish_timings(timings, results, bw, f32_peak, shape):
    """Add each kernel's bound (bytes over HBM rate or f32 operations over
    peak, whichever is longer) and its largest error, and print the line."""
    for name, t in timings.items():
        by_bytes, by_ops = t["bytes"] / bw * 1e3, t["flops"] / f32_peak * 1e3
        t["bound_ms"] = max(by_bytes, by_ops)
        t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        t["max_abs_err"], t["max_ulp"] = results[name]
        print(f"kernel {name} {shape} f32: kernel_ms={t['ms']:.5f} "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
              f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']}")


def same_bits(torch, name, got, want, results, label):
    """Kernel outputs against the plain version's, bit for bit (f32 by bit
    pattern, so signs of zero count); records the largest error, taken
    where the bits differ (an equal ±inf or NaN is no error)."""
    torch.cuda.synchronize()
    err, ulp, same = 0.0, 0, True
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            differ = a.view(torch.int32) != b.view(torch.int32)
            ulp = max(ulp, max_ulp(torch, a, b))
        else:
            differ = a != b
        if bool(differ.any()):
            same = False
            d = (a[differ].double() - b[differ].double()).abs()
            err = max(err, float(d.nan_to_num(nan=math.inf).max()))
    r = results.setdefault(name, [0.0, 0])
    r[0], r[1] = max(r[0], err), max(r[1], ulp)
    if not same:
        raise AssertionError(f"{name} differs from its plain version "
                             f"({label}): max_abs_err={err}, max_ulp={ulp}")


def ragged_codec_rows(torch, gen, lane, rows=333):
    """Rows with the codecs' edge cases: counts 0, partial and full, zero
    rows, −0.0 entries, and QSGD rounding ties (norm = s = 7 makes the
    scale exactly 1, so x = k + 0.5 is a tie)."""
    dev = torch.device(DEVICE)
    x = torch.randn((rows, lane), generator=gen, device=dev)
    counts = torch.full((rows, 1), float(lane), device=dev)
    for r, n in ((1, 0), (2, 17), (3, 1), (rows - 1, 0)):
        x[r, n:] = 0.0
        counts[r] = n
    x[4] = 0.0
    x[5] = -0.0
    x[6, ::3] = -0.0
    ties = torch.arange(-6.5, 7.0, 1.0, device=dev)
    x[7] = ties.repeat(-(-lane // ties.numel()))[:lane]
    x[7, 0] = 7.0
    return x, counts


def codec_kernel_phase(torch, ops, bw, f32_peak):
    """The CPD-SGDM codec kernels against their plain versions, bit for bit,
    at the main path's rows (ResNet-20 width 16 over K = 8 workers, with
    its real row counts) and at ragged rows; times at the main path's."""
    from repro_torch.kernels.qsgd_quant import qsgd_dequant, qsgd_quant
    from repro_torch.kernels.ref import (qsgd_rows_ref, qsgd_rows_unpack_ref,
                                         sign_pack_rows_ref, sign_unpack_ref)
    from repro_torch.kernels.sign_compress import sign_pack, sign_unpack
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)
    params = stacked_init(torch, 2)
    plan = ops.KernelPlan.for_tree(params, worker_dim=True)
    counts_main = ops.tile_counts(plan.row_counts(dev), plan.rows, (K,))
    x_main = plan.flatten({k: torch.randn(v.shape, generator=gen, device=dev)
                           for k, v in params.items()}).reshape(-1, ops.LANE)
    x_rag, counts_rag = ragged_codec_rows(torch, gen, ops.LANE)
    results = {}
    for label, x, counts in (("main", x_main, counts_main),
                             ("ragged", x_rag, counts_rag)):
        got = sign_pack(x, counts)
        same_bits(torch, "sign_pack", got, sign_pack_rows_ref(x, counts),
                  results, label)
        same_bits(torch, "sign_unpack", (sign_unpack(*got),),
                  (sign_unpack_ref(*got),), results, label)
        for levels in (1, QSGD_LEVELS, 127):
            got = qsgd_quant(x, levels=levels)
            same_bits(torch, "qsgd_quant", got, qsgd_rows_ref(x, levels),
                      results, f"{label}, levels {levels}")
            same_bits(torch, "qsgd_dequant",
                      (qsgd_dequant(*got, levels=levels),),
                      (qsgd_rows_unpack_ref(*got, levels),), results,
                      f"{label}, levels {levels}")
        print(f"kernel sign_pack/sign_unpack/qsgd_quant/qsgd_dequant "
              f"rows={x.shape[0]} (levels 1, {QSGD_LEVELS}, 127): bit-exact")

    rows, n = x_main.shape[0], x_main.numel()
    packed, scales = sign_pack(x_main, counts_main)
    qp, qn = qsgd_quant(x_main, levels=QSGD_LEVELS)
    lv = QSGD_LEVELS
    # no single PyTorch call computes any of these four functions, so
    # library_ms is None for each
    timings = {
        "sign_pack": dict(
            ms=time_ms(torch, lambda: sign_pack(x_main, counts_main)),
            plain_ms=time_ms(torch, lambda: sign_pack_rows_ref(x_main,
                                                               counts_main)),
            library_ms=None, bytes=4 * n + 4 * rows + packed.numel()
            + 4 * rows, flops=2 * n),               # |x|, +
        "sign_unpack": dict(
            ms=time_ms(torch, lambda: sign_unpack(packed, scales)),
            plain_ms=time_ms(torch, lambda: sign_unpack_ref(packed, scales)),
            library_ms=None, bytes=packed.numel() + 4 * rows + 4 * n,
            flops=n),                                # ±1 · scale
        "qsgd_quant": dict(
            ms=time_ms(torch, lambda: qsgd_quant(x_main, levels=lv)),
            plain_ms=time_ms(torch, lambda: qsgd_rows_ref(x_main, lv)),
            library_ms=None, bytes=4 * n + qp.numel() + 4 * rows,
            flops=4 * n),                            # |x|, max, ·qscale, +s
        "qsgd_dequant": dict(
            ms=time_ms(torch, lambda: qsgd_dequant(qp, qn, levels=lv)),
            plain_ms=time_ms(torch, lambda: qsgd_rows_unpack_ref(qp, qn, lv)),
            library_ms=None, bytes=qp.numel() + 4 * rows + 4 * n,
            flops=2 * n),                            # −s, ·scale
    }
    finish_timings(timings, results, bw, f32_peak, tuple(x_main.shape))
    return timings


def ragged_topk_rows(torch, gen, lane):
    """:func:`ragged_codec_rows` plus top-k's own edge cases: rows
    quantized to a few values, so ties abound, a row of equal |x| (the
    contended case of the radix select), −0.0 among a row's largest and
    below its zeros; a run of 12 equal |x| straddling the 103rd place (W at
    f = 0.1), a row of subnormals (they differ only in the low digits), a
    row with ±inf, and counts 1 and 1023 on full rows."""
    x, counts = ragged_codec_rows(torch, gen, lane)
    dev = x.device
    x[8] = torch.round(x[8] * 2.0) / 2.0
    x[9] = torch.sign(x[9])
    x[10, :200] = -0.0
    x[10, 200:] = 0.0
    x[11, :700] = 0.0
    x[11, 900:] = -0.0
    cols = torch.randperm(lane, generator=gen, device=dev)
    x[12] = torch.rand(lane, generator=gen, device=dev) * 0.5
    x[12, cols[:98]] = torch.arange(10.0, 108.0, device=dev)
    x[12, cols[98:110]] = 5.0 * torch.sign(
        torch.randn(12, generator=gen, device=dev))
    bits = torch.randint(1, 1 << 12, (lane,), generator=gen, device=dev,
                         dtype=torch.int32)
    x[13] = torch.where(torch.rand(lane, generator=gen, device=dev) < 0.5,
                        bits, bits | -2 ** 31).view(torch.float32)
    x[14, 5], x[14, 9], x[14, 700] = math.inf, -math.inf, math.inf
    counts[15] = 1
    counts[16] = lane - 1
    return x, counts


def duplicate_slots(torch, gen, lane, rows=333, w=103):
    """A scatter payload whose nonzero slots name columns more than once:
    small integers, so the sums are exact in any order and the plain
    version's atomic scatter_add has one answer; ±0.0 slots and the (0,
    0.0) placeholders among them."""
    dev = torch.device(DEVICE)
    idx = torch.randint(0, lane, (rows, w), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:, 5] = idx[:, 0]
    idx[:, 9] = idx[:, 0]
    idx[::2, 1:4] = idx[::2, 7:10]
    vals = torch.randint(-8, 9, (rows, w), generator=gen,
                         device=dev).to(torch.float32)
    vals[:, 11] = -0.0
    idx[:, 90:], vals[:, 90:] = 0, 0.0
    return idx, vals


def topk_kernel_phase(torch, ops, bw, f32_peak):
    """The top-k select and scatter against their plain versions, bit for
    bit, at the main path's rows (ResNet-20 width 16 over K = 8, its real
    row counts) and at ragged rows (:func:`ragged_topk_rows`), at f =
    0.001, 0.01, 0.1 and 0.125 (W = 2, 11, 103, 128); the select on rows
    with NaN, the scatter on a payload that repeats columns; times at the
    main path's f = 0.1, and the select's on rows of equal |x| and, at
    W = 128, on random full rows and on its worst case."""
    from repro_torch.kernels.ref import topk_rows_ref, topk_rows_unpack_ref
    from repro_torch.kernels.topk_select import topk_scatter, topk_select
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5678)
    params = stacked_init(torch, 2)
    plan = ops.KernelPlan.for_tree(params, worker_dim=True)
    counts_main = ops.tile_counts(plan.row_counts(dev), plan.rows, (K,))
    x_main = plan.flatten({k: torch.randn(v.shape, generator=gen, device=dev)
                           for k, v in params.items()}).reshape(-1, ops.LANE)
    x_rag, counts_rag = ragged_topk_rows(torch, gen, ops.LANE)
    results = {}
    for label, x, counts in (("main", x_main, counts_main),
                             ("ragged", x_rag, counts_rag)):
        for fraction in (0.001, 0.01, TOPK_FRACTION, 0.125):
            got = topk_select(x, counts, fraction=fraction)
            same_bits(torch, "topk_select", got,
                      topk_rows_ref(x, counts, fraction=fraction), results,
                      f"{label}, f={fraction}")
            same_bits(torch, "topk_scatter", (topk_scatter(*got),),
                      (topk_rows_unpack_ref(*got, ops.LANE),), results,
                      f"{label}, f={fraction}")
        print(f"kernel topk_select/topk_scatter rows={x.shape[0]} "
              f"(W = 2, 11, 103, 128): bit-exact")
    x_nan = x_rag.clone()
    x_nan[3, 100], x_nan[3, 50], x_nan[20, 7] = math.nan, -math.nan, math.nan
    for fraction in (0.001, TOPK_FRACTION):
        same_bits(torch, "topk_select", topk_select(x_nan, counts_rag,
                                                    fraction=fraction),
                  topk_rows_ref(x_nan, counts_rag, fraction=fraction),
                  results, f"NaN rows, f={fraction}")
    idx, vals = duplicate_slots(torch, gen, ops.LANE)
    same_bits(torch, "topk_scatter", (topk_scatter(idx, vals),),
              (topk_rows_unpack_ref(idx, vals, ops.LANE),), results,
              "repeated columns")
    print("kernel topk_select rows with NaN, topk_scatter with repeated "
          "columns: bit-exact")

    rows, n = x_main.shape[0], x_main.numel()
    f = TOPK_FRACTION
    idx, vals = topk_select(x_main, counts_main, fraction=f)
    w = idx.shape[1]
    idx64 = idx.long()
    slots = rows * w * 8                        # i32 idx + f32 val
    # a row of count 0 is all placeholders: the select reads none of its x
    live = int((counts_main > 0).sum())
    timings = {
        "topk_select": dict(
            ms=time_ms(torch, lambda: topk_select(x_main, counts_main,
                                                  fraction=f)),
            plain_ms=time_ms(torch, lambda: topk_rows_ref(
                x_main, counts_main, fraction=f)),
            # over every row: torch.topk cannot skip the dead ones
            library_ms=time_ms(torch, lambda: torch.topk(x_main.abs(), w,
                                                         dim=1)),
            bytes=4 * ops.LANE * live + 4 * rows + slots,
            flops=2 * ops.LANE * live),                  # |x|, compare
        "topk_scatter": dict(
            ms=time_ms(torch, lambda: topk_scatter(idx, vals)),
            plain_ms=time_ms(torch, lambda: topk_rows_unpack_ref(
                idx, vals, ops.LANE)),
            # zeros + scatter_add_ (int64 indices, converted once)
            library_ms=time_ms(torch, lambda: torch.zeros(
                (rows, ops.LANE), device=dev).scatter_add_(1, idx64, vals)),
            # every slot is read (only its value says it is a placeholder)
            bytes=slots + 4 * n,
            flops=int((vals != 0).sum())),               # one add a slot
    }
    finish_timings(timings, results, bw, f32_peak, tuple(x_main.shape))
    # rows of equal |x|: one histogram bin on every pass (the most
    # contended histograms), all four passes, and ties that need no rank
    x_eq = 0.5 * torch.sign(torch.randn(x_main.shape, generator=gen,
                                        device=dev))
    x_eq[x_eq == 0] = 0.5
    same_bits(torch, "topk_select", topk_select(x_eq, counts_main, fraction=f),
              topk_rows_ref(x_eq, counts_main, fraction=f), results,
              "equal |x|")
    t_eq = time_ms(torch, lambda: topk_select(x_eq, counts_main, fraction=f))
    print(f"kernel topk_select {tuple(x_main.shape)} f32, every |x| equal: "
          f"kernel_ms={t_eq:.5f} (random rows "
          f"{timings['topk_select']['ms']:.5f}, torch.topk "
          f"{timings['topk_select']['library_ms']:.5f})")
    # the worst case by construction: every row full at W = 128, all keys
    # in one first-pass bin (|x| in [1, 2)), distinct 23-bit mantissas
    # c·8191 in a random order, save that the 129th largest equals the
    # 128th; so all four passes run and 127 strict winners are ranked
    wide = 0.125
    m = torch.arange(ops.LANE, device=dev) * 8191
    m[ops.LANE - 129] = m[ops.LANE - 128]
    perm = torch.argsort(torch.rand(x_main.shape, generator=gen, device=dev),
                         dim=1)
    sign = torch.where(torch.rand(x_main.shape, generator=gen, device=dev)
                       < 0.5, -1.0, 1.0)
    x_worst = sign * (1.0 + m[perm].float() * 2.0 ** -23)
    x_rand = torch.randn(x_main.shape, generator=gen, device=dev)
    for label, xw in (("random rows", x_rand), ("worst case", x_worst)):
        same_bits(torch, "topk_select", topk_select(xw, fraction=wide),
                  topk_rows_ref(xw, fraction=wide), results,
                  f"full rows, {label}, f={wide}")
    t_worst, t_rand, t_lib = (
        time_ms(torch, lambda: topk_select(x_worst, fraction=wide)),
        time_ms(torch, lambda: topk_select(x_rand, fraction=wide)),
        time_ms(torch, lambda: torch.topk(x_rand.abs(), 128, dim=1)))
    print(f"kernel topk_select {tuple(x_main.shape)} f32, full rows, W=128, "
          f"worst case (one first-pass bin, four passes, 127 ranked): "
          f"kernel_ms={t_worst:.5f} (random rows {t_rand:.5f}, torch.topk "
          f"{t_lib:.5f})")
    return timings


def gather_edge_cases(torch, gen, lane):
    """Inputs for the gather's edge shapes: K = 1, 3, 8 workers, S = 1, 5,
    65 rows each (no multiple of a per-block row count) out of 333; counts
    0, 1, 17, 1023 and 1024 among the rows; NaN (with a payload), ±inf,
    −0.0 and a subnormal in lanes that every count ≥ 17 keeps and in the
    last lanes, which only 1024 keeps; repeated indices.  Yields
    ``(label, x, idx, counts)``."""
    dev = torch.device(DEVICE)
    special = torch.tensor([0x7FC00123, 0x7F800000, -0x800000, -2 ** 31, 5],
                           dtype=torch.int32, device=dev).view(torch.float32)
    rows = 333
    for k, s in ((1, 1), (3, 5), (8, 65)):
        x = torch.randn((k, rows, lane), generator=gen, device=dev)
        x[:, :, 3:8] = special                # NaN, +inf, -inf, -0.0, 5·2⁻¹⁴⁹
        x[:, :, lane - 5:] = special
        pick = torch.tensor([0.0, 1.0, 17.0, lane - 1.0, float(lane)],
                            device=dev)
        counts = pick[torch.randint(0, 5, (k * rows, 1), generator=gen,
                                    device=dev)]
        idx = torch.randint(0, rows, (k, s), generator=gen, device=dev,
                            dtype=torch.int32)
        if s > 1:
            idx[:, -1] = idx[:, 0]                # a repeated index
        yield f"edge K={k} S={s}", x, idx, counts


def gather_with_oob(torch, ops, x, idx, counts):
    """The plain gather where ``idx`` may leave ``[0, rows)``: a zero row
    there (the kernel's rule; the plain version itself would raise)."""
    from repro_torch.kernels.ref import row_gather_ref
    rows = x.shape[1]
    bad = (idx < 0) | (idx >= rows)
    out = row_gather_ref(x, torch.where(bad, 0, idx), counts)
    out[bad] = 0.0
    return out


def cold_ms(torch, launches, passes: int = 1):
    """Per-launch device time of ``launches`` (callables, each on inputs of
    its own), run ``passes`` times over, back to back between one pair of
    CUDA events.  A spin kernel ahead of the start event keeps the device
    busy until the host has enqueued every launch (checked: the start event
    must still be pending when the end event is enqueued, else the spin is
    doubled and the window taken again), so the window holds device time
    only.  The caller makes the launches' inputs cold: the bytes touched
    between two uses of one input exceed the 50 MB L2."""
    for fn in launches:                       # warm-up: build, allocator
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in launches:
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) * passes
    cycles = int(4 * host_s * 2e9) + SPIN_CYCLES
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(passes):
            for fn in launches:
                fn()
        end.record()
        if not start.query():
            end.synchronize()
            return start.elapsed_time(end) / (passes * len(launches))
        torch.cuda.synchronize()
        cycles *= 2
    raise RuntimeError("cold_ms: the host could not stay ahead of the card")


class bound_gather:
    """Within the block, ``row_gather`` launches the C function ``fn`` (a
    build of another ``row_gather.cu``) in place of the checkout's."""
    KEY = ("row_gather", "row_gather_f32")

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels import build
        from repro_torch.kernels.row_gather import _GATHER_ARGTYPES
        self.saved = build.load_function(*self.KEY, _GATHER_ARGTYPES)
        if self.fn is not None:
            build._FUNCS[self.KEY] = self.fn
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        build._FUNCS[self.KEY] = self.saved


def build_variant(path: str):
    """Compile another ``row_gather.cu`` (for a comparison in the same
    call) with the port's nvcc flags into a fresh temporary directory
    outside the checkout, and bind its ``row_gather_f32``."""
    import ctypes
    import tempfile
    from repro_torch.kernels import build
    from repro_torch.kernels.row_gather import _GATHER_ARGTYPES
    out = os.path.join(tempfile.mkdtemp(prefix="row_gather_variant_"),
                       "librow_gather.so")
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, path],
                         capture_output=True, text=True, timeout=600)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{log.stdout}"
                           f"{log.stderr}")
    for line in (log.stdout + log.stderr).splitlines():
        if any(w in line for w in PTXAS_WORDS):
            print(f"build: variant {path}: {line.strip()}")
    fn = ctypes.CDLL(out).row_gather_f32
    fn.argtypes, fn.restype = list(_GATHER_ARGTYPES), ctypes.c_int
    return fn


def gather_checks(torch, ops, results, label_prefix=""):
    """``row_gather`` (as bound now) against its plain version, bit for
    bit, at the edge shapes, with an index out of range, and at S = 1,024
    of the embedding plan, each with counts and without."""
    from repro_torch.kernels.ref import row_gather_ref
    from repro_torch.kernels.row_gather import row_gather
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2468)
    cases = list(gather_edge_cases(torch, gen, ops.LANE))
    x = torch.randn((EMB_K, 4096, ops.LANE), generator=gen, device=dev)
    idx = torch.sort(torch.stack([
        torch.randperm(4096, generator=gen, device=dev)[:GATHER_WIDE_S]
        for _ in range(EMB_K)]), dim=1)[0].to(torch.int32)
    counts = torch.full((EMB_K * 4096, 1), float(ops.LANE), device=dev)
    counts[5::97] = 17.0
    cases.append((f"K={EMB_K} rows=4096 S={GATHER_WIDE_S}", x, idx, counts))
    for label, x, idx, counts in cases:
        for c in (counts, None):
            same_bits(torch, "row_gather", (row_gather(x, idx, c),),
                      (row_gather_ref(x, idx, c),), results,
                      label_prefix + label)
    _, x, idx, counts = cases[1]                  # K = 3, S = 5
    idx = idx.clone()
    idx[0, 1], idx[1, 2], idx[2, 0] = -1, x.shape[1], 2 ** 31 - 1
    for c in (counts, None):
        same_bits(torch, "row_gather", (row_gather(x, idx, c),),
                  (gather_with_oob(torch, ops, x, idx, c),), results,
                  label_prefix + "indices out of range")
    print(f"kernel row_gather {label_prefix}edge shapes (K = 1, 3, 8; S = 1, "
          f"5, 65; counts 0, 1, 17, 1023, 1024; NaN, ±inf, −0.0, subnormal; "
          f"repeated and out-of-range indices) and S={GATHER_WIDE_S}: "
          f"bit-exact")


GATHER_WIDE_S = 1024    # the bandwidth check: 4 x 1,024 rows of 4 KiB


def gather_cold_inputs(torch, lane, s, copies: int = 4):
    """``copies`` fresh (K, 4096, 1024) matrices (64 MiB each) and, for
    each launch, an (x, idx, flat src) set whose S rows per worker no other
    launch of the pass gathers: so between two uses of one row the pass
    touches ``copies`` × 64 MiB, more than the 50 MB L2 holds."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1357)
    xs = [torch.randn((EMB_K, 4096, lane), generator=gen, device=dev)
          for _ in range(copies)]
    perms = [torch.stack([torch.randperm(4096, generator=gen, device=dev)
                          for _ in range(EMB_K)]) for _ in range(copies)]
    base = 4096 * torch.arange(EMB_K, device=dev)[:, None]
    sets = []
    for sl in range(4096 // s):
        for b in range(copies):
            idx = torch.sort(perms[b][:, sl * s:(sl + 1) * s], dim=1)[0]
            sets.append((xs[b], idx.to(torch.int32).contiguous(),
                         (idx + base).reshape(-1), sl))
    return sets


def gather_times(torch, ops, bw, variants, counts):
    """The gather's times by three methods, at S = 64 (the main path) and
    S = 1,024: per-launch windows (``time_ms``, inputs warm), back to back
    on cold inputs (``cold_ms``), for the checkout's kernel, each variant,
    ``index_select`` and a contiguous copy of the same bytes in one launch;
    in turns (forward, then backward), and the mean of the two turns;
    printed with the bound."""
    from repro_torch.kernels.row_gather import row_gather
    lane = ops.LANE
    dev = torch.device(DEVICE)
    for s in (EMB_MAX_ROWS, GATHER_WIDE_S):
        n = EMB_K * s                             # rows gathered a launch
        sets = gather_cold_inputs(torch, lane, s)
        dst = torch.empty((n, lane), device=dev)
        x0, idx0, src0, _ = sets[0]
        x2d0 = x0.reshape(-1, lane)
        kernels = [("kernel", None)] + list(variants)
        methods = []
        for label, fn in kernels:
            methods.append((label, fn,
                            lambda: row_gather(x0, idx0, counts),
                            [lambda x=x, i=i: row_gather(x, i, counts)
                             for x, i, _, _ in sets]))
        methods.append(("index_select", None,
                        lambda: torch.index_select(x2d0, 0, src0),
                        [lambda x=x, q=q: torch.index_select(
                            x.reshape(-1, lane), 0, q)
                         for x, _, q, _ in sets]))
        methods.append(("copy", None, lambda: dst.copy_(x2d0[:n]),
                        [lambda x=x, o=sl: dst.copy_(
                            x.reshape(-1, lane)[o * n:(o + 1) * n])
                         for x, _, _, sl in sets]))
        passes = max(1, 256 // len(sets))
        got = {label: [] for label, *_ in methods}
        for order in (methods, methods[::-1]):
            for label, fn, warm, cold in order:
                with bound_gather(fn):
                    got[label].append((time_ms(torch, warm),
                                       cold_ms(torch, cold, passes)))
        means = {label: [statistics.mean(v) for v in zip(*pairs)]
                 for label, pairs in got.items()}
        bound = (n * (8 + 2 * 4 * lane)) / bw * 1e3
        print(f"gather S={s} ({n} rows of 4 KiB, {len(sets)} cold input "
              f"sets x {passes} passes, 4 x 64 MiB; bound {bound:.5f} ms): "
              + "; ".join(f"{label} window {w:.5f} cold {c:.5f} ms"
                          for label, (w, c) in means.items()))


def row_kernel_phase(torch, ops, bw, f32_peak, variants=()):
    """The row gather and scatter against their plain versions, bit for
    bit, at the embedding path's plan ((4, 4096, 1024), 64 sorted distinct
    rows per worker) and at ragged rows (counts 0, 1, 17 and full, a −0.0
    row, −0.0 in the payload); the gather also at its edge shapes and at
    S = 1,024 (:func:`gather_checks`), for the checkout's kernel and each
    of ``variants`` (``(label, C function)``).  Times at the embedding
    plan, and the gather's by three methods at two shapes
    (:func:`gather_times`), with the window floor."""
    from repro_torch.kernels.ref import row_gather_ref, row_scatter_ref
    from repro_torch.kernels.row_gather import row_gather, row_scatter
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8765)
    table = {"table": torch.randn((EMB_K, EMB_ROWS, EMB_DIM), generator=gen,
                                  device=dev)}
    plan = ops.KernelPlan.for_tree(table, worker_dim=True)
    x_main = plan.flatten(table)
    counts_main = ops.tile_counts(plan.row_counts(dev), plan.rows, (EMB_K,))
    idx_main = torch.sort(torch.stack([
        torch.randperm(plan.rows, generator=gen, device=dev)[:EMB_MAX_ROWS]
        for _ in range(EMB_K)]), dim=1)[0].to(torch.int32)
    k_rag, rows_rag = 3, 333
    x_rag = torch.randn((k_rag, rows_rag, ops.LANE), generator=gen,
                        device=dev)
    x_rag[:, 1] = -0.0
    counts_rag = torch.full((k_rag * rows_rag, 1), float(ops.LANE),
                            device=dev)
    for r, c in ((1, 17), (2, 0), (3, 1), (rows_rag + 1, 0),
                 (2 * rows_rag + 3, 17)):
        counts_rag[r] = c
    idx_rag = torch.tensor([[1, 2, 3, 100 + k, rows_rag - 1]
                            for k in range(k_rag)], dtype=torch.int32,
                           device=dev)
    results = {}
    for label, x, idx, counts in (("main", x_main, idx_main, counts_main),
                                  ("ragged", x_rag, idx_rag, counts_rag)):
        for vlabel, fn in [("", None)] + list(variants):
            with bound_gather(fn):
                for c in (counts, None):
                    same_bits(torch, "row_gather", (row_gather(x, idx, c),),
                              (row_gather_ref(x, idx, c),), results,
                              f"{vlabel} {label}")
        g = row_gather(x, idx, counts)
        g[:, :, ::5] = -0.0
        same_bits(torch, "row_scatter",
                  (row_scatter(idx, g, rows=x.shape[1]),),
                  (row_scatter_ref(idx, g, rows=x.shape[1]),), results, label)
        print(f"kernel row_gather/row_scatter K={x.shape[0]} "
              f"rows={x.shape[1]} S={idx.shape[1]}: bit-exact")
    for vlabel, fn in [("", None)] + list(variants):
        with bound_gather(fn):
            gather_checks(torch, ops, results,
                          f"[{vlabel}] " if vlabel else "")

    floor_empty = time_ms(torch, lambda: None)
    floor_sleep = time_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"window floor (time_ms: the median of 30 windows, each behind a "
          f"1 ms spin): empty window {floor_empty:.5f} ms, one empty kernel "
          f"(torch.cuda._sleep(0)) {floor_sleep:.5f} ms")
    gather_times(torch, ops, bw, variants, counts_main)

    k, rows, s = EMB_K, plan.rows, EMB_MAX_ROWS
    g = row_gather(x_main, idx_main, counts_main)
    src = (idx_main.long() + rows * torch.arange(k, device=dev)[:, None]
           ).reshape(-1)
    x2d, g2d = x_main.reshape(-1, ops.LANE), g.reshape(-1, ops.LANE)
    row = 4 * ops.LANE
    timings = {
        "row_gather": dict(
            ms=time_ms(torch, lambda: row_gather(x_main, idx_main,
                                                 counts_main)),
            plain_ms=time_ms(torch, lambda: row_gather_ref(
                x_main, idx_main, counts_main)),
            library_ms=time_ms(torch, lambda: torch.index_select(x2d, 0,
                                                                 src)),
            bytes=k * s * (row + 4 + 4) + k * s * row,
            flops=k * s * ops.LANE),                  # one compare a lane
        "row_scatter": dict(
            ms=time_ms(torch, lambda: row_scatter(idx_main, g, rows=rows)),
            plain_ms=time_ms(torch, lambda: row_scatter_ref(idx_main, g,
                                                            rows=rows)),
            # zeros + index_copy_ (the rows are distinct)
            library_ms=time_ms(torch, lambda: torch.zeros(
                (k * rows, ops.LANE), device=dev).index_copy_(0, src, g2d)),
            bytes=k * s * (4 + row) + k * rows * row,  # the output whole
            flops=k * s * ops.LANE),                  # one add a lane
    }
    finish_timings(timings, results, bw, f32_peak,
                   (k, rows, ops.LANE, "S", s))
    return timings


def stacked_init(torch, seed: int, k: int = K, width: int = WIDTH):
    from repro_torch.models.resnet import resnet20_init
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = resnet20_init(gen, width=width, device=DEVICE)
    return {n: v.unsqueeze(0).repeat((k,) + (1,) * v.dim())
            for n, v in params.items()}


def batch_fn(seed: int, k: int = K, batch: int = BATCH, alpha=None):
    """Step t's class batch; ``alpha``: Dirichlet(α) labels per worker."""
    from repro_torch.data.synthetic import ClassStreamCfg, class_batch
    cfg = ClassStreamCfg(batch=batch, n_workers=k, seed=seed,
                         dirichlet_alpha=alpha)
    return lambda t: class_batch(cfg, t, DEVICE)


# the paths, the kernels each must launch in a 14-step run, and
# the path whose run each kernel's reported launches come from
PATHS = ("pd_sgdm", "cpd_sgdm_sign", "cpd_sgdm_qsgd", "cpd_sgdm_topk",
         "cpd_sgdm_sparse", "c_sgdm", "pd_sgdm_exp16", "pd_sgdm_onepeer",
         "mt_dsgdm", "mt_dsgdm_sign", "qg_dsgdm", "pd_sgdm_churn",
         "cpd_sgdm_sign_churn", "mt_dsgdm_sign_churn", "pd_sgdm_overlap",
         "mt_dsgdm_overlap", "qg_dsgdm_overlap", "pd_sgdm_bf16",
         "pd_sgdm_hier", "pd_sgdm_overlap_churn", "pd_sgdm_olmo1b",
         "pd_sgdm_mixtral", "pd_sgdm_minicpm3", "pd_sgdm_mamba2",
         "pd_sgdm_tinylm_hier", "cpd_sgdm_tinylm_sign")
LM_PATHS = ("pd_sgdm_olmo1b", "pd_sgdm_mixtral", "pd_sgdm_minicpm3",
            "pd_sgdm_mamba2", "pd_sgdm_tinylm_hier", "cpd_sgdm_tinylm_sign")
# MT: each step mixes ĝ = g + λx (n = 2) and c + ĝ − ĝ_prev (n = 3); each
# round mixes x and c (or the decoded Q(c))
MT_MIXES = 2 * STEPS + 2 * (STEPS // P)
# overlapped rounds: every round (the tail too) forms the stale mix at its
# start, every round lands it (ops.delayed_mix_mat) at its end
OV_MIXES = (STEPS // P + 1) + STEPS // P
# overlapped MT: the tracking mixes, a drip after every step, the stale
# mixes of x and c, the landings
MT_OV_MIXES = 2 * STEPS + STEPS + 2 * (STEPS // P + 1) + STEPS // P
WORKERS = {"cpd_sgdm_sparse": EMB_K, "pd_sgdm_exp16": EXP_K,
           "pd_sgdm_mixtral": MIXTRAL_K}
EXPECTED = {
    "pd_sgdm": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    # C-SGDM: p = 1, the gradient mean is a matmul, no gossip
    "c_sgdm": {"momentum_update": STEPS},
    # 9 views a round, all in one launch
    "pd_sgdm_exp16": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    # a time-varying graph mixes through W_r @ x on the matrix
    "pd_sgdm_onepeer": {"momentum_update": STEPS},
    "cpd_sgdm_sign": {"momentum_update": STEPS, "sign_pack": STEPS // P,
                      "sign_unpack": STEPS // P},
    "cpd_sgdm_qsgd": {"momentum_update": STEPS, "qsgd_quant": STEPS // P,
                      "qsgd_dequant": STEPS // P},
    "cpd_sgdm_topk": {"momentum_update": STEPS, "topk_select": STEPS // P,
                      "topk_scatter": STEPS // P},
    "cpd_sgdm_sparse": {"momentum_update": STEPS, "row_gather": STEPS // P,
                        "row_scatter": STEPS // P},
    "mt_dsgdm": {"momentum_update": STEPS, "gossip_mix": MT_MIXES},
    "mt_dsgdm_sign": {"momentum_update": STEPS, "gossip_mix": MT_MIXES,
                      "sign_pack": STEPS // P, "sign_unpack": STEPS // P},
    # QG: the buffer update at a round is plain elementwise torch
    "qg_dsgdm": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    # under churn the gossip is W_r @ x with round r's masked W; CPD packs
    # on the tree at the round boundary through the sign kernels; MT's
    # compressed correction takes the per-leaf codec (no sign launch)
    "pd_sgdm_churn": {"momentum_update": STEPS},
    "cpd_sgdm_sign_churn": {"momentum_update": STEPS, "sign_pack": STEPS // P,
                            "sign_unpack": STEPS // P},
    "mt_dsgdm_sign_churn": {"momentum_update": STEPS,
                            "gossip_mix": 2 * STEPS},
    "pd_sgdm_overlap": {"momentum_update": STEPS, "gossip_mix": OV_MIXES},
    "mt_dsgdm_overlap": {"momentum_update": STEPS, "gossip_mix": MT_OV_MIXES},
    "qg_dsgdm_overlap": {"momentum_update": STEPS, "gossip_mix": OV_MIXES},
    # the shifted mix, its neighbour views read from the bf16 round trip
    "pd_sgdm_bf16": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    # the factored two-level round on the matrix: a mean and a matmul
    "pd_sgdm_hier": {"momentum_update": STEPS},
    # the stale mix is W̃_r @ x with the delivery round's masked W; the
    # landing is the kernel
    "pd_sgdm_overlap_churn": {"momentum_update": STEPS,
                              "gossip_mix": STEPS // P},
    # the LM paths: the full-width rings mix through the shifted kernel
    # (Mixtral's ring(2): 2 views, one launch); the hierarchical round has
    # no gossip launch; CPD's sign wire packs the LM tree's 107 ragged rows
    "pd_sgdm_olmo1b": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    "pd_sgdm_mixtral": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    "pd_sgdm_minicpm3": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    "pd_sgdm_mamba2": {"momentum_update": STEPS, "gossip_mix": STEPS // P},
    "pd_sgdm_tinylm_hier": {"momentum_update": STEPS},
    "cpd_sgdm_tinylm_sign": {"momentum_update": STEPS,
                             "sign_pack": STEPS // P,
                             "sign_unpack": STEPS // P},
}
# the gradient leaves one step of each path reads in place and copies
# first (``momentum_update.leaf_reads`` / ``leaf_copies``): PD's and CPD's
# rounds hand the momentum launch every leaf; of ResNet-20's 61, the 21
# conv kernels' grads (autograd leaves them as transposed views of the
# HWIO leaf) and the 10-element head bias are copied; C-SGDM, MT and QG
# flatten theirs and read none
RESNET_LEAVES = (39, 22)
LEAVES = {
    **{path: RESNET_LEAVES for path in (
        "pd_sgdm", "cpd_sgdm_sign", "cpd_sgdm_qsgd", "cpd_sgdm_topk",
        "pd_sgdm_exp16", "pd_sgdm_onepeer", "pd_sgdm_churn",
        "cpd_sgdm_sign_churn", "pd_sgdm_overlap", "pd_sgdm_bf16",
        "pd_sgdm_hier", "pd_sgdm_overlap_churn")},
    "cpd_sgdm_sparse": (1, 0),
    "pd_sgdm_olmo1b": (8, 0), "pd_sgdm_mixtral": (13, 0),
    "pd_sgdm_minicpm3": (17, 0), "pd_sgdm_mamba2": (12, 0),
    "pd_sgdm_tinylm_hier": (12, 0), "cpd_sgdm_tinylm_sign": (12, 0),
}
OWNER = {"momentum_update": "pd_sgdm", "gossip_mix": "pd_sgdm",
         "sign_pack": "cpd_sgdm_sign", "sign_unpack": "cpd_sgdm_sign",
         "qsgd_quant": "cpd_sgdm_qsgd", "qsgd_dequant": "cpd_sgdm_qsgd",
         "topk_select": "cpd_sgdm_topk", "topk_scatter": "cpd_sgdm_topk",
         "row_gather": "cpd_sgdm_sparse", "row_scatter": "cpd_sgdm_sparse"}


def counters() -> dict:
    """Every kernel wrapper by name; each carries its ``launches`` count."""
    from repro_torch.kernels.gossip_mix import gossip_mix
    from repro_torch.kernels.momentum import momentum_update
    from repro_torch.kernels.qsgd_quant import qsgd_dequant, qsgd_quant
    from repro_torch.kernels.row_gather import row_gather, row_scatter
    from repro_torch.kernels.sign_compress import sign_pack, sign_unpack
    from repro_torch.kernels.topk_select import topk_scatter, topk_select
    return {"momentum_update": momentum_update, "gossip_mix": gossip_mix,
            "sign_pack": sign_pack, "sign_unpack": sign_unpack,
            "qsgd_quant": qsgd_quant, "qsgd_dequant": qsgd_dequant,
            "topk_select": topk_select, "topk_scatter": topk_scatter,
            "row_gather": row_gather, "row_scatter": row_scatter}


def make_opt(path: str, use_kernel: bool, max_rows: int = EMB_MAX_ROWS):
    """The optimizer of ``path``, built as a user builds it (``max_rows``:
    the sparse wire's row budget, as ``--compressor-rows`` sets it)."""
    from repro_torch.core import (CPDSGDM, CPDSGDMConfig, DenseComm,
                                  QSGDCompressor, SignCompressor,
                                  SparseRowsCompressor, TopKCompressor,
                                  make_optimizer, make_schedule,
                                  make_topology, membership_from_events, ring)
    if path == "cpd_sgdm_sparse":
        return CPDSGDM(CPDSGDMConfig(use_kernel=use_kernel, **EMB_HYPER),
                       DenseComm(ring(EMB_K), device=DEVICE),
                       SparseRowsCompressor(max_rows=max_rows))
    if path in FULL_WIDTH:
        return make_optimizer(
            "pd_sgdm", DenseComm(ring(WORKERS.get(path, K)), device=DEVICE),
            use_kernel=use_kernel, **FULL_HYPER)
    if path == "pd_sgdm_tinylm_hier":
        return make_optimizer("pd_sgdm", DenseComm(
            make_topology("hierarchical", HIER), device=DEVICE),
            use_kernel=use_kernel, **TINY_HYPER)
    if path == "cpd_sgdm_tinylm_sign":
        return make_optimizer("cpd_sgdm", DenseComm(ring(K), device=DEVICE),
                              gamma=GAMMA, compressor=SignCompressor(),
                              use_kernel=use_kernel, **TINY_HYPER)
    graph = {"pd_sgdm_exp16": make_topology("exponential", (EXP_K,)),
             "pd_sgdm_onepeer": make_schedule(ONE_PEER, (K,)),
             "pd_sgdm_hier": make_topology("hierarchical", HIER)}.get(
                 path, ring(K))
    membership = None
    if path.endswith("_churn"):
        membership = membership_from_events(K, CHURN_ROUNDS, CHURN_EVENTS)
        path = path[:-len("_churn")]
    overlap = path.endswith("_overlap")
    if overlap:
        path = path[:-len("_overlap")]
    comm = DenseComm(graph, membership=membership, device=DEVICE,
                     wire_dtype=("bfloat16" if path == "pd_sgdm_bf16"
                                 else "float32"))
    if path in ("pd_sgdm", "pd_sgdm_exp16", "pd_sgdm_onepeer",
                "pd_sgdm_bf16", "pd_sgdm_hier"):
        return make_optimizer("pd_sgdm", comm, use_kernel=use_kernel,
                              overlap=overlap, **HYPER)
    if path == "c_sgdm":        # make_optimizer swaps in complete(K)
        return make_optimizer("c_sgdm", comm, use_kernel=use_kernel, **HYPER)
    if path in ("mt_dsgdm", "mt_dsgdm_sign", "qg_dsgdm"):
        name = "qg_dsgdm" if path == "qg_dsgdm" else "mt_dsgdm"
        comp = SignCompressor() if path == "mt_dsgdm_sign" else None
        return make_optimizer(name, comm, use_kernel=use_kernel,
                              compressor=comp, overlap=overlap,
                              **dict(HYPER, eta=TRACK_ETA))
    comp, gamma = {
        "cpd_sgdm_sign": (None, GAMMA),                   # None: sign
        "cpd_sgdm_qsgd": (QSGDCompressor(levels=QSGD_LEVELS), GAMMA),
        "cpd_sgdm_topk": (TopKCompressor(fraction=TOPK_FRACTION), TOPK_GAMMA),
    }[path]
    return make_optimizer("cpd_sgdm", comm, gamma=gamma, compressor=comp,
                          use_kernel=use_kernel, **HYPER)


def embedding_grads(torch):
    """The reference benchmark's embedding-style gradient: 0.01 added to
    each looked-up row of each worker's table (repeats add up), and no
    loss: the gradient is non-zero exactly on the touched rows."""
    def grads_fn(params, batch):
        table, ids = params["table"], batch["ids"]
        g = torch.zeros_like(table)
        k = torch.arange(table.shape[0], device=table.device)[:, None]
        g.index_put_((k.expand_as(ids), ids),
                     torch.tensor(0.01, device=table.device), accumulate=True)
        return torch.zeros((), device=table.device), {"table": g}
    return grads_fn


def embedding_run(torch, opt, params, seed: int, steps: int):
    """``steps`` steps through ``opt.round``: whole rounds of p steps, then
    a tail of local steps without gossip; Zipf lookups of ``seed``."""
    from repro_torch.data.synthetic import EmbedStreamCfg, embed_batch
    cfg = EmbedStreamCfg(n_rows=EMB_ROWS, dim=EMB_DIM, batch=EMB_BATCH,
                         n_workers=EMB_K, seed=seed)
    grads_fn = embedding_grads(torch)
    state = opt.init(params)
    done = 0
    while done < steps:
        n = min(P, steps - done)
        batches = {"ids": torch.stack([embed_batch(cfg, t, DEVICE)["ids"]
                                       for t in range(done, done + n)])}
        params, state, _ = opt.round(state, params, grads_fn, batches,
                                     gossip=n == P)
        done += n
    return params, state


def lm_model(path: str):
    """The model of an LM path, through ``make_model``."""
    from repro_torch.configs.base import ModelCfg
    from repro_torch.configs.registry import get_config
    from repro_torch.models import make_model
    if path in FULL_WIDTH:
        full = FULL_WIDTH[path]
        return make_model(dataclasses.replace(
            get_config(full["arch"]).model, param_dtype="float32",
            compute_dtype="float32", **full["cuts"]))
    return make_model(ModelCfg(**TINY_LM))


def seq_batch(path: str):
    """The sequence length and batch a worker of an LM path."""
    if path in FULL_WIDTH:
        return FULL_WIDTH[path]["seq"], FULL_WIDTH[path]["batch"]
    return TINY_SEQ, TINY_BATCH


def lm_stream(path: str, seed: int):
    """Step t's LM batch of ``path``, its K workers, from ``seed``."""
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    seq, batch = seq_batch(path)
    cfg = LMStreamCfg(vocab=lm_model(path).cfg.vocab, seq_len=seq,
                      batch=batch, n_workers=WORKERS.get(path, K), seed=seed)
    return lambda t: lm_batch(cfg, t, DEVICE)


def lm_init(torch, path: str, seed: int) -> dict:
    """K workers from the same x0 (Algorithm 1's input), drawn from
    ``seed`` on the card."""
    one = lm_model(path).init(torch.Generator(device=DEVICE).manual_seed(seed),
                              device=DEVICE)
    k = WORKERS.get(path, K)
    return {n: v.expand((k,) + v.shape).contiguous() for n, v in one.items()}


def lm_grads_fn(torch, path: str):
    """What ``SimTrainer`` hands the round: the mean loss and the
    per-worker grads of ``vmap(grad_and_value(loss))``."""
    model = lm_model(path)
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda prm, b: model.loss(prm, b)[0]))

    def grads_fn(prm, b):
        g, losses = grad(prm, b)
        return losses.mean(), g
    return grads_fn


def drive(torch, opt, path: str, seed: int, steps: int):
    """``steps`` steps of ``path`` with ``opt`` from the init of ``seed``;
    returns ``(init, params, state, history)`` (history None on the
    embedding path, which has no loss).  A full-width path's init is
    handed to the trainer and not kept (it would hold a copy of the params
    through the run, 8.2 GB of OLMo's, 11.9 GB of Mixtral's): its ``init``
    is the params' shapes on the meta device."""
    from repro_torch.train.trainer import SimTrainer
    if path in LM_PATHS:
        model = lm_model(path)
        trainer = SimTrainer(lambda prm, b: model.loss(prm, b), opt,
                             device=DEVICE)
        if path in FULL_WIDTH:
            out = trainer.train(lm_init(torch, path, seed),
                                lm_stream(path, seed), steps, log_every=1)
            k = WORKERS.get(path, K)
            init = {n: torch.empty((k,) + shape, device="meta")
                    for n, shape in model.param_shapes().items()}
            return (init,) + out
        init = lm_init(torch, path, seed)
        return (init,) + trainer.train(init, lm_stream(path, seed), steps,
                                       log_every=1)
    if path == "cpd_sgdm_sparse":
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        init = {"table": torch.randn((EMB_K, EMB_ROWS, EMB_DIM),
                                     generator=gen, device=DEVICE) * 0.1}
        return (init,) + embedding_run(torch, opt, init, seed, steps) + (None,)
    from repro_torch.models.resnet import resnet20_loss
    k = WORKERS.get(path, K)
    init = stacked_init(torch, seed, k)
    out = SimTrainer(resnet20_loss, opt, device=DEVICE).train(
        init, batch_fn(seed, k), steps, log_every=1)
    return (init,) + out


def describe(path: str) -> str:
    """The model and batch of a path, as the training phase prints them."""
    if path not in LM_PATHS:
        return f"ResNet-20 width {WIDTH}, batch {BATCH}"
    model = lm_model(path)
    cfg = model.cfg
    seq, batch = seq_batch(path)
    n = sum(math.prod(s) for s in model.param_shapes().values())
    mixers = {spec.mixer for spec in cfg.pattern}
    parts = [f"pattern {[(sp.mixer, sp.ffn) for sp in cfg.pattern]}"]
    if mixers & {"attn", "mla"}:
        parts.append(f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv")
    if "mla" in mixers:
        parts.append(f"MLA q_lora {cfg.q_lora_rank}, kv_lora "
                     f"{cfg.kv_lora_rank}, nope/rope {cfg.qk_nope_dim}/"
                     f"{cfg.qk_rope_dim}, v_head {cfg.v_head_dim}")
    if "mamba" in mixers:
        s = model.mamba_cfg
        parts.append(f"SSD d_inner {s.d_inner}, {s.n_heads} heads of "
                     f"headdim {s.headdim}, d_state {s.d_state}, conv "
                     f"{s.conv_kernel}, chunk {s.chunk}")
    if any(spec.ffn != "none" for spec in cfg.pattern):
        parts.append(f"d_ff {cfg.d_ff}, "
                     f"{'gated SiLU' if cfg.gated_mlp else 'GELU'}")
    if cfg.n_experts:
        parts.append(f"{cfg.n_experts} experts top-{cfg.top_k} at capacity "
                     f"factor {cfg.capacity_factor}, {cfg.moe_groups} "
                     f"dispatch group(s)")
    return (f"{cfg.name} (n_layers {cfg.n_layers}, d_model {cfg.d_model}, "
            f"{', '.join(parts)}, window {cfg.window}, vocab {cfg.vocab}, "
            f"{cfg.norm}, {cfg.param_dtype}; {n:,} params a worker), seq "
            f"{seq}, batch {batch}")


def training_phase(torch, path: str) -> dict:
    """One path, once, with every launch counter set to 0 just before."""
    gc.collect()
    torch.cuda.empty_cache()
    kernels = counters()
    opt = make_opt(path, use_kernel=True)
    drive(torch, opt, path, 0, P)                  # warm-up round, not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    mom = kernels["momentum_update"]
    mom.leaf_reads = mom.leaf_copies = 0
    t0 = time.perf_counter()
    init, out, state, hist = drive(torch, opt, path, 0, STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    leaves = (mom.leaf_reads, mom.leaf_copies)
    one = {k: v[0] for k, v in init.items()}
    cycle = opt.bytes_per_round_cycle(one)
    # bytes through the run's rounds, round r at cycle[r % T]
    rounds = STEPS // opt.config.p
    want_mb = sum(cycle[r % len(cycle)] for r in range(rounds)) / 2 ** 20
    comm = opt.comm
    graph = (comm.schedule.name if comm.schedule is not None
             else comm.topology.name)
    if comm.membership is not None:
        graph += f" under {CHURN_EVENTS}"
    if hist is None:
        comm_mb = want_mb
        print(f"train: {path} kernel path, {EMB_ROWS} x {EMB_DIM} f32 table "
              f"per worker, K={EMB_K} ring, Zipf batch {EMB_BATCH}, p={P}, "
              f"{STEPS} steps through CPDSGDM.round")
    else:
        comm_mb = hist.comm_mb[-1]
        print(f"train: {path} kernel path, {describe(path)}, "
              f"K={comm.topology.n_workers} {graph}, "
              f"p={opt.config.p}, eta={opt.config.eta}, {STEPS} steps")
        print(f"train: {path} losses " + " ".join(f"{v:.4f}"
                                                   for v in hist.loss))
        if (not all(math.isfinite(v) for v in hist.loss)
                or len(hist.loss) != STEPS):
            raise AssertionError(f"{path}: bad losses {hist.loss}")
    print(f"train: {path} {seconds:.3f} s for {STEPS} steps, "
          f"{seconds * opt.config.p / STEPS:.4f} s per round, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"train: {path} launches {launches}, gradient leaves read in "
          f"place {leaves[0]}, copied first {leaves[1]}, bytes per round "
          f"{cycle[0] if len(cycle) == 1 else cycle}, comm_mb {comm_mb}")
    want = {name: EXPECTED[path].get(name, 0) for name in kernels}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected {want}")
    want = tuple(STEPS * n for n in LEAVES.get(path, (0, 0)))
    if leaves != want:
        raise AssertionError(f"{path}: gradient leaves read in place and "
                             f"copied first {leaves}, expected {want}")
    if cycle != WIRE_BYTES[path] or comm_mb != want_mb:
        raise AssertionError(f"{path}: {cycle} B per round, comm_mb "
                             f"{comm_mb}, expected {WIRE_BYTES[path]}")
    if int(state["step"]) != STEPS:
        raise AssertionError(f"{path}: step counter {int(state['step'])}")
    for name, v in out.items():
        if v.shape != init[name].shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{path}: bad final param {name}")
    return launches


def parity_phase(torch, path: str):
    """One kernel-path round of ``path`` against one round of its plain
    path from the same init on the same batches, with cuDNN held to
    deterministic algorithms so both see the same gradients; on the
    one-peer schedule the whole cycle of three rounds, so that every W_r
    is held (the churn paths hold theirs round by round:
    ``round_parity_phase``).  The plain path is the tree round for PD-SGDM, C-SGDM,
    MT-DSGDm and QG-DSGDm (MT's sign-compressed correction through the
    per-leaf codec) and, for every CPD-SGDM wire, the round through the
    per-leaf codec (``_kernel_wire`` off), which launches no kernel: the
    round holds the codec kernels against the plain codec.  Params within
    atol 1e-4 / rtol 1e-3, and so m and MT's and QG's c, ĝ_prev and
    x_prev.
    CPD's x̂ too, except where the two consensus products (one over
    the matrix, one per leaf) put the drift x_new − x̂ on opposite sides of
    a sign, a QSGD tie or a top-k or row-norm near-tie: x̂ moves there by
    at most 2·max|drift|, in a handful of elements."""
    if path.endswith("_churn") or "_overlap" in path:
        return round_parity_phase(torch, path)
    if path in FULL_WIDTH:
        return full_width_parity_phase(torch, path)
    kernels = counters()
    torch.backends.cudnn.deterministic = True
    opt = make_opt(path, True)
    steps = opt.config.p * opt.comm.round_cycle
    init, got, sk, hk = drive(torch, opt, path, 1, steps)
    plain = make_opt(path, False)
    cpd = path.startswith("cpd")
    if cpd:
        plain._kernel_wire = lambda: False          # the per-leaf codec
    before = {name: fn.launches for name, fn in kernels.items()}
    _, want, st, ht = drive(torch, plain, path, 1, steps)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    stray = {name: fn.launches - before[name] for name, fn in kernels.items()
             if fn.launches != before[name]}
    if stray:
        raise AssertionError(f"{path}: the plain round launched {stray}")
    losses = (f", losses {hk.loss} vs {ht.loss}" if hk is not None else "")
    hold_parity(torch, path, f"{steps} steps, kernel path vs "
                f"{'per-leaf codec' if cpd else 'tree'} path", init,
                (got, sk), (want, st), losses)


def host_available_gib() -> float:
    """The host's available memory (``MemAvailable``), in GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def full_width_parity_phase(torch, path: str):
    """One kernel round of a full-width path against one tree round from
    the same start on the same batches, at ``parity_phase``'s bars.  Both
    rounds cannot sit on the card at once (8.2 GB a copy of OLMo's params,
    11.9 GB of Mixtral's), so the start and the kernel round's params and m
    go to the host (three copies: the host's available memory is checked
    first), the card is freed, and the tree round runs from the start
    copied back, handed to it with no other reference so that it frees
    the start after its first step, as a trainer does; the two are compared
    leaf by leaf on the card."""
    kernels = counters()
    opt, plain = make_opt(path, True), make_opt(path, False)
    grads_fn = lm_grads_fn(torch, path)
    data = lm_stream(path, 1)
    steps = [data(i) for i in range(opt.config.p)]
    batches = {k: torch.stack([b[k] for b in steps]) for k in steps[0]}
    copy_gib = sum(4 * WORKERS.get(path, K) * math.prod(s) for s in
                   lm_model(path).param_shapes().values()) / 2 ** 30
    free_gib = host_available_gib()
    print(f"parity: {path} host memory available {free_gib:.1f} GiB for 3 "
          f"copies of {copy_gib:.2f} GiB")
    if free_gib < 3 * copy_gib + 4:
        raise RuntimeError(f"{path}: the host has {free_gib:.1f} GiB "
                           f"available, the parity round needs "
                           f"{3 * copy_gib + 4:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    start = lm_init(torch, path, 1)
    host_start = {k: v.cpu() for k, v in start.items()}
    got, sk, lk = opt.round(opt.init(start), start, grads_fn, batches)
    host = {"params": {k: v.cpu() for k, v in got.items()},
            "m": {k: v.cpu() for k, v in sk["m"].items()}}
    lk = lk.tolist()
    del start, got, sk
    gc.collect()
    torch.cuda.empty_cache()
    start = [{k: v.to(DEVICE) for k, v in host_start.items()}]
    del host_start
    before = {name: fn.launches for name, fn in kernels.items()}
    want, st, lt = plain.round(plain.init(start[0]), start.pop(), grads_fn,
                               batches)
    torch.cuda.synchronize()
    stray = {name: fn.launches - before[name] for name, fn in kernels.items()
             if fn.launches != before[name]}
    if stray:
        raise AssertionError(f"{path}: the plain round launched {stray}")
    gaps = {}
    for what, plain_tree in (("params", want), ("m", st["m"])):
        worst = 0.0
        for k, ref in plain_tree.items():
            a = host[what][k].to(DEVICE)
            worst = max(worst, float((a - ref).abs().max()))
            if not torch.allclose(a, ref, rtol=1e-3, atol=1e-4):
                raise AssertionError(f"{path}: kernel round's {what} "
                                     f"differs from the tree round's: {k}")
            del a
        gaps[what] = worst
    print(f"parity: {path} round of {opt.config.p} steps, kernel path vs "
          f"tree path, from the host copy of the start: max |Δparam| = "
          f"{gaps['params']}, max |Δm| = {gaps['m']}, losses {lk} vs "
          f"{lt.tolist()}")
    del want, st, host
    gc.collect()
    torch.cuda.empty_cache()


# the full-width MoE layer's bar: max |Δy| over max |y|.  The port and
# the plain formulation sum their f32 matmuls (TF32 off) in other orders,
# a few ulps of each output; inputs rounded to bf16 alone move y by about
# 2^-9 of its size, far past the bar (the phase shows it)
MOE_BAR = 2e-5


def plain_moe(torch, p, xf, C: int, k: int, dtype):
    """Mixtral's MoE layer written out expert by expert, apart from the
    port's dispatch: the f32 router and its top-k, renormalised; for each
    expert the tokens routed to it in token order, the first ``C`` kept,
    through the gated SiLU FFN with the matmuls' inputs in ``dtype``; each
    output times its gate, added to its token.  Returns (y, top-k ids,
    kept (N, E) mask, aux loss without its weight)."""
    import torch.nn.functional as F
    N, E = xf.shape[0], p["wi"].shape[0]
    gates = torch.softmax(xf @ p["router"]["w"], dim=-1)
    top_w, top_e = torch.topk(gates, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    kept = torch.zeros((N, E), dtype=torch.bool, device=xf.device)
    y = torch.zeros_like(xf)
    for e in range(E):
        hit = top_e == e                      # (N, k), one slot at most
        rows = hit.any(-1).nonzero()[:, 0][:C]
        kept[rows, e] = True
        xe = xf[rows].to(dtype)
        h = (F.silu((xe @ p["wg"][e].to(dtype)).float())
             * (xe @ p["wi"][e].to(dtype)).float())
        out = (h.to(dtype) @ p["wo"][e].to(dtype)).float()
        y.index_add_(0, rows, out * (top_w * hit)[rows].sum(-1, keepdim=True))
    f_e = (top_e[..., None] == torch.arange(E, device=xf.device)).float()
    aux = E * torch.sum(gates.mean(0) * f_e.sum(1).mean(0) / k)
    return y, top_e, kept, aux


def moe_layer_phase(torch):
    """Mixtral's MoE layer at its published widths (d 4096, d_ff 14336, 8
    experts top-2, capacity factor 1.25: C = 160 slots an expert) on one
    worker's 512 tokens, through the port's ``moe_apply`` against
    :func:`plain_moe`, on two inputs: standard normal tokens, which the
    random router spreads about evenly (no expert past C), and the same
    tokens plus one shared random row, which biases every token towards
    the same experts so that slots overflow (it must drop some).  On each:
    the top-2 expert ids, the kept-slot mask and the count of dropped
    slots exactly equal, the aux loss within rtol 1e-6, and y within
    ``MOE_BAR`` of max |y|; the plain formulation with bf16 matmul inputs
    must miss that bar."""
    from repro_torch.models import moe
    path = "pd_sgdm_mixtral"
    gc.collect()
    torch.cuda.empty_cache()
    model = lm_model(path)
    cfg = model.moe_cfg
    one = model.init(torch.Generator(device=DEVICE).manual_seed(5),
                     device=DEVICE)
    pre = "blocks.pos0.moe."
    p = {"router": {"w": one[pre + "router.w"][0]},
         **{n: one[pre + n][0] for n in ("wi", "wg", "wo")}}
    del one
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    batch, seq = FULL_WIDTH[path]["batch"], FULL_WIDTH[path]["seq"]
    x = torch.randn((batch, seq, cfg.d_model), device=DEVICE,
                    generator=gen)
    shared = torch.randn((cfg.d_model,), device=DEVICE, generator=gen)
    N, E, k = batch * seq, cfg.n_experts, cfg.top_k
    C = moe.capacity(N, cfg)
    for label, xs in (("even", x), ("skewed", x + shared)):
        y, aux = moe.moe_apply(p, xs, cfg)
        xf = xs.reshape(N, cfg.d_model)
        _, top_w, top_e = moe.route(p, xf, cfg)
        _, (sorted_e, _, tok, _, keep) = moe.dispatch(
            xf[None], top_w[None], top_e[None], C, cfg)
        kept = torch.zeros((N, E), dtype=torch.bool, device=DEVICE)
        kept[tok[0], sorted_e[0]] = keep[0]
        want, want_e, want_kept, want_aux = plain_moe(torch, p, xf, C, k,
                                                      torch.float32)
        torch.cuda.synchronize()
        drops = N * k - int(kept.sum())
        want_drops = N * k - int(want_kept.sum())
        load = torch.bincount(want_e.reshape(-1), minlength=E).tolist()
        scale = float(want.abs().max())
        gap = float((y.reshape(N, -1) - want).abs().max()) / scale
        print(f"moe: {path} layer at full width, {label} tokens, {N} "
              f"tokens, C = {C}, slots an expert {load}: dropped {drops} "
              f"(plain {want_drops}) of {N * k}; top-{k} ids and kept mask "
              f"equal: {torch.equal(top_e, want_e)}, "
              f"{torch.equal(kept, want_kept)}; max |Δy| / max |y| = "
              f"{gap:.3e} (bar {MOE_BAR}, max |y| {scale:.4f}); aux "
              f"{float(aux)} vs {cfg.router_aux_weight * float(want_aux)}")
        if not (torch.equal(top_e, want_e) and torch.equal(kept, want_kept)
                and drops == want_drops):
            raise AssertionError(f"{path}: the MoE layer's routing differs "
                                 f"from the plain formulation's ({label})")
        if label == "skewed" and drops == 0:
            raise AssertionError(f"{path}: the skewed tokens dropped no slot")
        if gap > MOE_BAR:
            raise AssertionError(f"{path}: the MoE layer's output is "
                                 f"{gap:.3e} of max |y| from the plain one "
                                 f"({label})")
        if not math.isclose(float(aux),
                            cfg.router_aux_weight * float(want_aux),
                            rel_tol=1e-6):
            raise AssertionError(f"{path}: the MoE layer's aux loss differs "
                                 f"({label})")
    low = plain_moe(torch, p, xf, C, k, torch.bfloat16)[0]
    low_gap = float((low - want).abs().max()) / scale
    print(f"moe: {path} the plain formulation with bf16 matmul inputs: "
          f"max |Δy| / max |y| = {low_gap:.3e}, past the bar: "
          f"{low_gap > MOE_BAR}")
    if not low_gap > MOE_BAR:
        raise AssertionError(f"{path}: the bar {MOE_BAR} does not tell f32 "
                             "from bf16")
    del p, x, xs, y, want, low
    gc.collect()
    torch.cuda.empty_cache()


# the full-width MLA and SSD layers' bars: max |Δy| over max |y|.  The
# port and the plain formulations sum their f32 matmuls (TF32 off), the
# softmax and the scan in other orders, a few ulps of each output; the
# projections' inputs rounded to bf16 move y by about 2^-9 of its size, far
# past the bars (the phases show it)
MLA_BAR = 2e-5
SSD_BAR = 2e-5


def layer_params(torch, path: str, mixer: str, seed: int) -> dict:
    """One worker's params of the first layer's mixer of ``path``'s model
    (drawn by ``Model.init`` on the card), as the mixer's nested dict."""
    one = lm_model(path).init(torch.Generator(device=DEVICE).manual_seed(
        seed), device=DEVICE)
    pre = f"blocks.pos0.{mixer}."
    out: dict = {}
    for name, v in one.items():
        if name.startswith(pre):
            *inner, leaf = name[len(pre):].split(".")
            d = out
            for q in inner:
                d = d.setdefault(q, {})
            d[leaf] = v[0]
    return out


def plain_mla(torch, p, x, cfg, theta: float, dtype):
    """MiniCPM3's MLA written out apart from the port: the low-rank query
    and the KV latent through their RMSNorms, the rotary halves turned by
    RoPE's tables, the one rotary key head copied into every head, the keys
    and values expanded per head, and ``F.scaled_dot_product_attention``
    (causal, scale (nope + rope)^-0.5); the matmuls' inputs in ``dtype``."""
    import torch.nn.functional as F
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    half = rope // 2

    def mm(a, w):
        return (a.to(dtype) @ w["w"].to(dtype)).float()

    def norm(a, w):
        return (a * torch.rsqrt(a.square().mean(-1, keepdim=True) + 1e-6)
                * w["scale"])

    inv = 1.0 / (theta ** (torch.arange(0, rope, 2, device=x.device,
                                        dtype=torch.float32) / rope))
    ang = torch.outer(torch.arange(s, device=x.device,
                                   dtype=torch.float32), inv)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]

    def rot(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], -1)

    q = mm(norm(mm(x, p["wdq"]), p["q_norm"]), p["wuq"]).view(
        b, s, h, nope + rope)
    q = torch.cat([q[..., :nope], rot(q[..., nope:])], -1)
    ckv = norm(mm(x, p["wdkv"]), p["kv_norm"])
    k_rope = rot(mm(x, p["wkr"])[:, :, None, :]).repeat(1, 1, h, 1)
    k = torch.cat([mm(ckv, p["wuk"]).view(b, s, h, nope), k_rope], -1)
    v = mm(ckv, p["wuv"]).view(b, s, h, cfg.v_head_dim)
    out = F.scaled_dot_product_attention(
        *(t.transpose(1, 2).to(dtype) for t in (q, k, v)), is_causal=True,
        scale=(nope + rope) ** -0.5).float()
    return mm(out.transpose(1, 2).reshape(b, s, -1), p["wo"])


def mla_layer_phase(torch):
    """MiniCPM3's MLA layer at its published widths (d 2560, 40 heads,
    q_lora 768, kv_lora 256, nope/rope 64/32, v_head 64) on one worker's
    512 tokens (batch 2 × seq 256), through the port's ``mla_apply``
    against :func:`plain_mla`: y within ``MLA_BAR`` of max |y|; the plain
    formulation with bf16 matmul inputs must miss that bar."""
    from repro_torch.models import attention
    from repro_torch.models.layers import rope_freqs
    path = "pd_sgdm_minicpm3"
    gc.collect()
    torch.cuda.empty_cache()
    model = lm_model(path)
    cfg, theta = model.attn_cfg, model.cfg.rope_theta
    p = layer_params(torch, path, "attn", 7)
    batch, seq = FULL_WIDTH[path]["batch"], FULL_WIDTH[path]["seq"]
    x = torch.randn((batch, seq, cfg.d_model), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(8))
    cos, sin = rope_freqs(cfg.qk_rope_dim, seq, theta, device=DEVICE)
    y = attention.mla_apply(p, x, cfg, cos, sin)
    want = plain_mla(torch, p, x, cfg, theta, torch.float32)
    low = plain_mla(torch, p, x, cfg, theta, torch.bfloat16)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    gap = float((y - want).abs().max()) / scale
    low_gap = float((low - want).abs().max()) / scale
    print(f"mla: {path} layer at full width, {batch * seq} tokens, "
          f"{cfg.n_heads} heads, q/kv rank {cfg.q_lora_rank}/"
          f"{cfg.kv_lora_rank}, nope/rope {cfg.qk_nope_dim}/"
          f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}: max |Δy| / max |y| = "
          f"{gap:.3e} against the explicit per-head K/V and "
          f"scaled_dot_product_attention (bar {MLA_BAR}, max |y| "
          f"{scale:.4f}); with bf16 matmul inputs {low_gap:.3e}, past the "
          f"bar: {low_gap > MLA_BAR}")
    if not gap <= MLA_BAR:
        raise AssertionError(f"{path}: the MLA layer's output is {gap:.3e} "
                             f"of max |y| from the plain one")
    if not low_gap > MLA_BAR:
        raise AssertionError(f"{path}: the bar {MLA_BAR} does not tell f32 "
                             "from bf16")
    del p, x, y, want, low
    gc.collect()
    torch.cuda.empty_cache()


def plain_ssd(torch, p, u, cfg, dtype, reset: bool = False):
    """Mamba-2's mixer written out apart from the port, its SSD as the
    sequential scan over positions, in f32: the projection (inputs in
    ``dtype``), the depthwise causal conv as ``F.conv1d`` and SiLU,
    ``dt = softplus(dt + dt_bias)``, then for each position ``S ← S·exp(dt·A)
    + dt·B⊗x`` and ``y = C·S + D·x``, the gated RMSNorm and ``out_proj``.
    ``reset`` zeroes S at each chunk's start: what the chunked form would
    give without its recurrence across chunks."""
    import torch.nn.functional as F
    b, s, _ = u.shape
    h, hd, n, di = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.d_inner
    k = cfg.conv_kernel

    def mm(a, w):
        return (a.to(dtype) @ w["w"].to(dtype)).float()

    z, xBC, dt = mm(u, p["in_proj"]).split([di, cfg.conv_dim, h], -1)
    xBC = F.silu(F.conv1d(xBC.transpose(1, 2), p["conv_w"].T[:, None, :],
                          p["conv_b"], padding=k - 1,
                          groups=cfg.conv_dim)[..., :s].transpose(1, 2))
    x, B, C = xBC.split([di, n, n], -1)          # one group: B, C shared
    x = x.reshape(b, s, h, hd)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    S = torch.zeros((b, h, n, hd), device=u.device)
    ys = []
    for t in range(s):
        if reset and t % cfg.chunk == 0:
            S = torch.zeros_like(S)
        S = (S * torch.exp(dt[:, t] * A)[:, :, None, None]
             + B[:, t, None, :, None] * (dt[:, t, :, None] * x[:, t])[
                 :, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S)
                  + p["D"][:, None] * x[:, t])
    g = torch.stack(ys, 1).reshape(b, s, di) * F.silu(z)
    g = (g * torch.rsqrt(g.square().mean(-1, keepdim=True) + 1e-6)
         * p["norm"]["scale"])
    return mm(g, p["out_proj"])


def ssd_layer_phase(torch):
    """Mamba2-1.3B's mixer at its published widths (d 2048, d_inner 4096,
    64 heads of headdim 64, d_state 128, conv 4, chunk 256) on one worker's
    1,024 positions, four chunks, through the port's chunked
    ``mamba2_apply`` against :func:`plain_ssd`'s sequential scan: y within
    ``SSD_BAR`` of max |y|.  ``dt_bias`` is Mamba-2's published init, the
    inverse softplus of a dt drawn log-uniform in [0.001, 0.1] per head,
    so that the state carries across chunks; the scan with its state reset
    at each chunk's start, and the scan with bf16 projection inputs, must
    each miss the bar."""
    from repro_torch.models import mamba2
    path = "pd_sgdm_mamba2"
    gc.collect()
    torch.cuda.empty_cache()
    cfg = lm_model(path).mamba_cfg
    p = layer_params(torch, path, "mamba", 9)
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    dt = torch.exp(torch.rand((cfg.n_heads,), device=DEVICE, generator=gen)
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    batch, seq = FULL_WIDTH[path]["batch"], FULL_WIDTH[path]["seq"]
    u = torch.randn((batch, seq, cfg.d_model), device=DEVICE, generator=gen)
    y = mamba2.mamba2_apply(p, u, cfg)
    want = plain_ssd(torch, p, u, cfg, torch.float32)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    gap = float((y - want).abs().max()) / scale
    misses = {label: float((plain_ssd(torch, p, u, cfg, dtype, reset)
                            - want).abs().max()) / scale
              for label, dtype, reset in (
                  ("state reset at each chunk", torch.float32, True),
                  ("bf16 projection inputs", torch.bfloat16, False))}
    print(f"ssd: {path} mixer at full width, {batch * seq} positions in "
          f"{seq // cfg.chunk} chunks of {cfg.chunk}, {cfg.n_heads} heads x "
          f"{cfg.headdim}, d_state {cfg.d_state}: max |Δy| / max |y| = "
          f"{gap:.3e} against the sequential scan (bar {SSD_BAR}, max |y| "
          f"{scale:.4f}); " + "; ".join(f"{label} {v:.3e}"
                                        for label, v in misses.items()))
    if not gap <= SSD_BAR:
        raise AssertionError(f"{path}: the SSD mixer's output is {gap:.3e} "
                             f"of max |y| from the sequential scan")
    for label, v in misses.items():
        if not v > SSD_BAR:
            raise AssertionError(f"{path}: the bar {SSD_BAR} does not tell "
                                 f"the chunked SSD from the scan with "
                                 f"{label}")
    del p, u, y, want
    gc.collect()
    torch.cuda.empty_cache()


def hold_parity(torch, path, what, start, kernel, plain, losses=""):
    """The bars of ``parity_phase`` on the params and state that a kernel
    run and a plain run reached from the params ``start``."""
    (got, sk), (want, st) = kernel, plain
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"parity: {path} {what}: max |Δparam| = {worst}{losses}")
    for k in want:
        if not torch.allclose(got[k], want[k], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"{path}: kernel round differs from the "
                                 f"plain round: {k}")
    tracked = {key: (sk[key], st[key]) for key in ("m", "c", "g_prev",
                                                  "xprev") if key in st}
    for key in ("buf", "buf_c"):            # an overlapped round's payload
        if key in st.get("mix", {}):
            tracked[f"mix.{key}"] = (sk["mix"][key], st["mix"][key])
    gaps = {key: max(float((a[k] - b[k]).abs().max()) for k in b)
            for key, (a, b) in tracked.items()}
    print(f"parity: {path} max |Δ| of the state: {gaps}")
    for key, (a, b) in tracked.items():
        for k, ref in b.items():
            if not torch.allclose(a[k], ref, rtol=1e-3, atol=1e-4):
                raise AssertionError(f"{path}: kernel round's {key} "
                                     f"differs from the plain round's: {k}")
    if "xhat" not in st:
        return
    drift = max(float((want[k] - start[k]).abs().max()) for k in want)
    worst, moved = 0.0, 0
    for k, ref in st["xhat"].items():
        gap = (sk["xhat"][k] - ref).abs()
        far = ~torch.isclose(sk["xhat"][k], ref, rtol=1e-3, atol=1e-4)
        worst, moved = max(worst, float(gap.max())), moved + int(far.sum())
        if int(far.sum()) > 8 or not bool((gap[far] <= 2 * drift).all()):
            raise AssertionError(f"{path}: kernel x̂ differs from the "
                                 f"per-leaf x̂: {k}")
    print(f"parity: {path} max |Δx̂| = {worst}, {moved} elements moved by a "
          f"sign, level or selection (max |drift| {drift})")


def round_parity_phase(torch, path: str):
    """Each round of a churn path's 3-round cycle held on its own: from the
    kernel path's params and state after the rounds before it, one kernel
    round against one plain round (as in ``parity_phase``) on the same
    batches, at ``parity_phase``'s bars, so that every masked W_r is held.
    Both paths mix with ``W_r @ x``, one over the matrix and one per leaf,
    and cuBLAS sums the K terms in an order that depends on the shape: a
    masked W_r (weights 1/3 and 2/3) leaves them an ulp apart, which the
    next round does not inherit (ReLU flips would grow it).  An overlapped
    path takes one round more than its cycle, and at least 3, so that
    every stale matrix lands (round 0 is a gated no-op); the in-flight
    payload is held with the state.  MT drips its stale tracking delta
    into every local step, so an ulp of the stale mix (``W @ x`` per leaf
    against the kernel's left-to-right sum) would reach the gradients
    within the round, where a ReLU input within rounding of zero flips
    (on the CPU rehearsal: 4e-4 in m); its plain round therefore sums the
    stale mix per leaf in the kernel's order (``plain_gossip``, the plain
    version), and the two rounds differ only where the kernels would."""
    from repro_torch.models.resnet import resnet20_loss
    kernels = counters()
    opt, plain = make_opt(path, True), make_opt(path, False)
    cpd = path.startswith("cpd")
    if cpd:
        plain._kernel_wire = lambda: False          # the per-leaf codec
    if plain.overlap_refreshes and plain.comm.membership is None:
        top = plain.comm.topology

        def stale_mix(tree, r=None):
            return {k: plain_gossip(top, v.reshape(v.shape[0], -1, 1),
                                    v[0].numel()).reshape(v.shape)
                    for k, v in tree.items()}

        plain.comm.stale_mix = stale_mix
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda prm, b: resnet20_loss(prm, b)[0]))

    def grads_fn(prm, b):
        g, losses = grad(prm, b)
        return losses.mean(), g

    p = opt.config.p
    data = batch_fn(1)
    params = stacked_init(torch, 1)
    state = opt.init(params)
    rounds = opt.comm.round_cycle
    if opt.config.overlap:
        rounds = max(rounds + 1, 3)
    with cudnn_deterministic(torch):
        for r in range(rounds):
            steps = [data(r * p + i) for i in range(p)]
            batches = {k: torch.stack([b[k] for b in steps])
                       for k in steps[0]}
            got, sk, lk = opt.round(state, params, grads_fn, batches)
            before = {name: fn.launches for name, fn in kernels.items()}
            want, st, lt = plain.round(state, params, grads_fn, batches)
            torch.cuda.synchronize()
            stray = {name: fn.launches - before[name]
                     for name, fn in kernels.items()
                     if fn.launches != before[name]}
            if stray:
                raise AssertionError(f"{path}: the plain round launched "
                                     f"{stray}")
            hold_parity(torch, path, f"round {r} of {p} steps, kernel "
                        f"path vs {'per-leaf codec' if cpd else 'tree'} "
                        f"path", params, (got, sk), (want, st),
                        f", losses {lk.tolist()} vs {lt.tolist()}")
            params, state = got, sk


class cudnn_deterministic:
    """Within the block, cuDNN runs deterministic algorithms: a figure's
    verdict reads single batches' losses, and the other algorithms'
    atomics move them from call to call."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        self.torch.backends.cudnn.deterministic = False


def fig_run(torch, name: str, steps: int, log_every: int, *, p: int = 4,
            eta: float = 0.1, gamma: float = 0.4, weight_decay: float = 1e-4,
            compressor=None, alpha=None, eval_fn=None, overlap=False):
    """One run at the reference's figure settings (``benchmarks/common.py``):
    ResNet-20 width 4 from seed 0, K = 8 workers (the complete graph for
    C-SGDM, else a ring), batch 16 of seed 0's class stream (Dirichlet(α)
    labels with ``alpha``), μ = 0.9, through ``make_optimizer`` →
    ``SimTrainer.train`` on the kernel layout (``overlap``: overlapped
    rounds).  Returns ``(History, wall seconds)``."""
    from repro_torch.core import DenseComm, complete, make_optimizer, ring
    from repro_torch.models.resnet import resnet20_loss
    from repro_torch.train.trainer import SimTrainer
    comm = DenseComm(complete(FIG1_K) if name == "c_sgdm" else ring(FIG1_K),
                     device=DEVICE)
    opt = make_optimizer(name, comm, eta=eta, mu=0.9, p=p, gamma=gamma,
                         weight_decay=weight_decay, compressor=compressor,
                         use_kernel=True, overlap=overlap)
    params = stacked_init(torch, 0, FIG1_K, FIG1_WIDTH)
    t0 = time.perf_counter()
    _, _, hist = SimTrainer(resnet20_loss, opt, device=DEVICE).train(
        params, batch_fn(0, FIG1_K, FIG1_BATCH, alpha), steps,
        log_every=log_every, eval_fn=eval_fn)
    torch.cuda.synchronize()
    return hist, time.perf_counter() - t0


def verdict(phase: str, missed: list, t0: float):
    """Print the phase's verdict and wall seconds; fail on a miss."""
    print(f"{phase}: verdict {'missed ' + str(missed) if missed else 'held'}"
          f", {time.perf_counter() - t0:.2f} s wall")
    if missed:
        raise AssertionError(f"{phase}: {missed}")


def fig1_phase(torch):
    """Fig. 1 on the card at the reference's settings
    (``benchmarks/common.py``, ``benchmarks/fig1_pdsgdm.py``): ResNet-20
    width 4, K = 8, batch 16 per worker, η = 0.1, μ = 0.9, weight decay
    1e-4, 90 steps logged every max(5, p), on the kernel layout; C-SGDM on
    complete(8) and PD-SGDM at p = 4, 8 and 16 on ring(8).  The bars of
    ``tests/test_system.py:test_pdsgdm_matches_csgdm_loss`` (which runs
    p = 4 and 8), here for every run, p = 16 included: the final loss
    below the first loss − 1.0 and below C-SGDM's final loss + 0.5.
    cuDNN is held to deterministic algorithms, so that the losses are the
    same on every call: the final loss is one step's batch loss, and with
    the other algorithms' atomics two calls of the same code ended PD at
    p = 16 at 0.20 and at 0.75."""
    t0 = time.perf_counter()
    first, final = {}, {}
    with cudnn_deterministic(torch):
        for name, p in FIG1_RUNS:
            hist, seconds = fig_run(torch, name, FIG1_STEPS, max(5, p), p=p)
            label = f"fig1/{name}_p{p}"
            first[label], final[label] = hist.loss[0], hist.loss[-1]
            print(f"fig1: {label} loss {hist.loss[0]:.4f} -> "
                  f"{hist.loss[-1]:.4f} (logged: "
                  f"{' '.join(f'{v:.3f}' for v in hist.loss)}), comm_mb "
                  f"{hist.comm_mb[-1]:.1f}, {seconds:.2f} s")
    base = final["fig1/c_sgdm_p1"]
    gap = max(abs(v - base) for v in final.values())
    print(f"fig1: final losses {json.dumps(final)}; max_gap_to_csgdm {gap}")
    missed = [label for label in final
              if not (final[label] < first[label] - 1.0
                      and final[label] < base + 0.5)]
    verdict("fig1", missed + [f"{label} final {v}" for label, v
                              in final.items() if not math.isfinite(v)], t0)


def fig2_phase(torch):
    """Fig. 2 on the card at the reference's settings
    (``benchmarks/fig2_comm_cost.py``): PD-SGDM at p = 4, 8 and 16 and
    CPD-SGDM with ``SignCompressor(block=64)`` at p = 4 and 16, 60 steps
    logged every 5, η = 0.1, γ = 0.4, weight decay 1e-4; rows as the
    reference prints them (``name,µs per step,derived``: total MB, MB to
    loss 1.2, final loss).  The claims: CPD at p = 16 ships fewer MB than
    PD at p = 16 (``cpd_over_pd_bytes_ratio_p16`` < 1), and CPD at p = 4
    fewer than a tenth of PD's at p = 4 (``tests/test_system.py:68``);
    every loss finite."""
    from repro_torch.core import SignCompressor
    t0 = time.perf_counter()
    runs = {}
    with cudnn_deterministic(torch):
        for label, name, p in (("pd_sgdm_p4", "pd_sgdm", 4),
                               ("pd_sgdm_p8", "pd_sgdm", 8),
                               ("pd_sgdm_p16", "pd_sgdm", 16),
                               ("cpd_sgdm_p4_sign", "cpd_sgdm", 4),
                               ("cpd_sgdm_p16_sign", "cpd_sgdm", 16)):
            comp = SignCompressor(block=64) if name == "cpd_sgdm" else None
            hist, seconds = fig_run(torch, name, FIG2_STEPS, 5, p=p,
                                    compressor=comp)
            runs[label] = hist
            mb = next((mb for loss, mb in zip(hist.loss, hist.comm_mb)
                       if loss <= FIG2_TARGET), math.nan)
            print(f"fig2/{label},{seconds / FIG2_STEPS * 1e6:.1f},"
                  f"total_mb={hist.comm_mb[-1]:.2f};"
                  f"mb_to_loss{FIG2_TARGET}={mb:.2f};"
                  f"final={hist.loss[-1]:.4f}")
    total = {label: h.comm_mb[-1] for label, h in runs.items()}
    ratio = total["cpd_sgdm_p16_sign"] / max(total["pd_sgdm_p16"], 1e-9)
    print(f"fig2/cpd_over_pd_bytes_ratio_p16,0.0,ratio={ratio:.4f}")
    missed = [label for label, h in runs.items()
              if not all(math.isfinite(v) for v in h.loss)]
    if not ratio < 1.0:
        missed.append(f"cpd_over_pd_bytes_ratio_p16 {ratio} >= 1")
    if not total["cpd_sgdm_p4_sign"] < total["pd_sgdm_p4"] / 10.0:
        missed.append(f"CPD p=4 {total['cpd_sgdm_p4_sign']} MB >= PD p=4 "
                      f"{total['pd_sgdm_p4']} MB / 10")
    verdict("fig2", missed, t0)


def fig3_phase(torch):
    """Fig. 3 on the card at the reference's settings
    (``benchmarks/fig3_cpdsgdm.py``): at p = 4 (CHOCO-SGD p = 1), 70 steps
    logged every 5, η = 0.1, weight decay 1e-4: PD-SGDM full precision,
    CPD-SGDM with sign (block 64), 4-bit QSGD (7 levels) and top-10 % at
    γ = 0.2, and CHOCO-SGD with sign (block 64); rows as the reference
    prints them, and ``sign_vs_full_gap``.  Then the bars of
    ``tests/test_system.py:test_cpdsgdm_matches_pdsgdm_with_less_comm`` at
    that test's settings (no weight decay): CPD sign-64 over 150 steps
    against PD over 90; the least of CPD's last 6 logged losses below its
    first − 1.5 and below PD's least of the last 6 + 0.75, and CPD's
    comm-MB below a tenth of PD's."""
    from repro_torch.core import (QSGDCompressor, SignCompressor,
                                  TopKCompressor)
    t0 = time.perf_counter()
    final, missed = {}, []
    with cudnn_deterministic(torch):
        for label, name, kw in (
                ("pd_sgdm_p4_full", "pd_sgdm", {}),
                ("cpd_sgdm_p4_sign", "cpd_sgdm",
                 dict(compressor=SignCompressor(block=64))),
                ("cpd_sgdm_p4_qsgd4bit", "cpd_sgdm",
                 dict(compressor=QSGDCompressor(levels=QSGD_LEVELS))),
                ("cpd_sgdm_p4_top10pct", "cpd_sgdm",
                 dict(gamma=TOPK_GAMMA,
                      compressor=TopKCompressor(fraction=TOPK_FRACTION))),
                ("choco_sgd_sign", "choco_sgd",
                 dict(compressor=SignCompressor(block=64)))):
            hist, seconds = fig_run(torch, name, FIG3_STEPS, 5, **kw)
            final[label] = hist.loss[-1]
            if not all(math.isfinite(v) for v in hist.loss):
                missed.append(f"{label} losses not finite")
            print(f"fig3/{label},{seconds / FIG3_STEPS * 1e6:.1f},"
                  f"final_loss={hist.loss[-1]:.4f};"
                  f"comm_mb={hist.comm_mb[-1]:.2f}")
        gap = abs(final["cpd_sgdm_p4_sign"] - final["pd_sgdm_p4_full"])
        print(f"fig3/sign_vs_full_gap,0.0,gap={gap:.4f}")
        h_pd, _ = fig_run(torch, "pd_sgdm", FIG3_PD_STEPS, 5,
                          weight_decay=0.0)
        h_cpd, _ = fig_run(torch, "cpd_sgdm", FIG3_CPD_STEPS, 5,
                           weight_decay=0.0,
                           compressor=SignCompressor(block=64))
    tail_cpd, tail_pd = min(h_cpd.loss[-6:]), min(h_pd.loss[-6:])
    print(f"fig3: test_system bars: CPD sign-64 {FIG3_CPD_STEPS} steps "
          f"first {h_cpd.loss[0]:.4f}, least of the last 6 {tail_cpd:.4f}, "
          f"comm_mb {h_cpd.comm_mb[-1]:.2f}; PD {FIG3_PD_STEPS} steps least "
          f"of the last 6 {tail_pd:.4f}, comm_mb {h_pd.comm_mb[-1]:.2f}")
    if not tail_cpd < h_cpd.loss[0] - 1.5:
        missed.append(f"CPD tail {tail_cpd} >= first {h_cpd.loss[0]} - 1.5")
    if not tail_cpd < tail_pd + 0.75:
        missed.append(f"CPD tail {tail_cpd} >= PD tail {tail_pd} + 0.75")
    if not h_cpd.comm_mb[-1] < h_pd.comm_mb[-1] / 10.0:
        missed.append(f"CPD {h_cpd.comm_mb[-1]} MB >= PD "
                      f"{h_pd.comm_mb[-1]} MB / 10")
    verdict("fig3", missed, t0)


def noniid_phase(torch):
    """The non-IID sweep's claim on the card (``benchmarks/noniid_sweep.py``
    at α = 0.1): Dirichlet(0.1) labels per worker, K = 8 ring, 64 steps,
    η = 0.05, μ = 0.9, weight decay 1e-4; D-SGD once, and PD-SGDM,
    QG-DSGDm and MT-DSGDm at p = 1, 2 and 4.  Each run is judged by
    ``eval_fn``: the global loss of the worker-averaged model on two IID
    batches of 32 (steps 10,000 and 10,001 of the same seed's class
    means).  Rows as the reference prints them (final global loss, the
    last local loss, comm MB).  The claim ``noniid/claim_alpha0.1``: the
    least over p of MT − PD is ≤ 0 (``mt_le_pd`` = 1).  Synchronous MT may
    diverge at p = 4, as the reference's own run records; a difference
    that is not finite takes no part in the least.  At p = 4 MT runs again
    with overlapped rounds (``mt_dsgdm_ov``, the stale tracking delta
    dripped into every local step), and ``noniid/claim_p4_overlap`` holds
    if its last local loss is finite and below 10
    (``mt_overlap_survives_p4`` = 1), printed beside synchronous MT's."""
    from repro_torch.data.synthetic import ClassStreamCfg, class_batch
    from repro_torch.models.resnet import resnet20_loss
    t0 = time.perf_counter()
    ecfg = ClassStreamCfg(batch=32, n_workers=FIG1_K, seed=0)
    evals = [class_batch(ecfg, 10_000 + i, DEVICE) for i in range(2)]
    vloss = torch.func.vmap(lambda p, b: resnet20_loss(p, b)[0])

    def eval_fn(avg):
        with torch.no_grad():
            return float(torch.stack([vloss(avg, b).mean()
                                      for b in evals]).mean())

    label = f"{NONIID_ALPHA:g}"
    results, local = {}, {}
    with cudnn_deterministic(torch):
        for p in NONIID_PS:
            for name in ("d_sgd", "pd_sgdm", "qg_dsgdm", "mt_dsgdm",
                         "mt_dsgdm_ov"):
                if name == "d_sgd" and p != NONIID_PS[0]:
                    continue         # D-SGD gossips every step: p-free
                if name == "mt_dsgdm_ov" and p < 4:
                    continue         # where synchronous MT's c ages
                overlap = name.endswith("_ov")
                hist, seconds = fig_run(
                    torch, name[:-3] if overlap else name, NONIID_STEPS,
                    NONIID_STEPS - 1, p=p, eta=TRACK_ETA, alpha=NONIID_ALPHA,
                    eval_fn=eval_fn, overlap=overlap)
                results[(p, name)] = hist.eval_metric[-1]
                local[(p, name)] = hist.loss[-1]
                tag = "" if name == "d_sgd" else f"_p{p}"
                print(f"noniid/{name}_a{label}{tag},"
                      f"{seconds / NONIID_STEPS * 1e6:.1f},"
                      f"final_loss={hist.eval_metric[-1]:.4f};"
                      f"local_loss={hist.loss[-1]:.4f};"
                      f"comm_mb={hist.comm_mb[-1]:.2f}")
    diffs = {p: results[(p, "mt_dsgdm")] - results[(p, "pd_sgdm")]
             for p in NONIID_PS}
    finite = {p: d for p, d in diffs.items() if math.isfinite(d)}
    best_p = min(finite, key=finite.get) if finite else None
    best = finite[best_p] if finite else math.nan
    mt_le_pd = int(best <= 0.0)
    print(f"noniid/claim_alpha{label},0.0,mt_minus_pd_best={best:.4f};"
          f"best_p={best_p};mt_le_pd={mt_le_pd}")
    ov, sync = local[(4, "mt_dsgdm_ov")], local[(4, "mt_dsgdm")]
    survives = int(math.isfinite(ov) and ov < 10.0)
    print(f"noniid/claim_p4_overlap,0.0,mt_sync_local_p4={sync:.4f};"
          f"mt_overlap_local_p4={ov:.4f};overlap_minus_sync_global="
          f"{results[(4, 'mt_dsgdm_ov')] - results[(4, 'mt_dsgdm')]:.4f};"
          f"mt_overlap_survives_p4={survives}")
    missed = [] if mt_le_pd else [f"mt_le_pd = 0: MT - PD by p {diffs}"]
    if not survives:
        missed.append(f"mt_overlap_survives_p4 = 0: local loss {ov}")
    verdict("noniid", missed, t0)


def elastic_phase(torch):
    """``benchmarks/elastic_sweep.py``'s claims on the card at its settings:
    K = 8 ring, a heterogeneous quadratic ``0.5‖x − b_k‖²`` over D = 64,
    p = 2, η = 0.05, μ = 0.9, 16 rounds, chaos script seed 7 at churn 0
    (``full_membership``), 0.1 and 0.25; PD-SGDM, CPD-SGDM with the sign
    wire (γ = 0.5), MT-DSGDm and QG-DSGDm through the port's
    ``run_dense_chaos`` on the kernel layout.  b and x₀ come from the
    card's generator (seeds 3 and 0), so the losses are not the
    reference's; the bytes depend only on the script and the shapes.
    Rows as the reference prints them.  Held: every round's matrix passes
    ``check_round_matrix``; every round's accounted bytes equal
    ``oracle_fleet_bytes``; every cell's ``mb_total`` equals the committed
    ``BENCH_elastic.json``'s to its 4 printed decimals, and so PD's
    ``bytes_saved_frac`` at 0.25 is 0.8516; ``survivors_bounded`` = 1
    (each cell's final loss within 2×, its peak consensus within 5×, of
    its optimizer's churn-free run)."""
    from repro_torch.core import DenseComm, SignCompressor, make_optimizer
    from repro_torch.core.topology import full_membership, ring
    from repro_torch.testing import (chaos_script, check_round_matrix,
                                     membership_for, oracle_fleet_bytes,
                                     run_dense_chaos)
    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "benchmarks", "BENCH_elastic.json")) as f:
        bench = {row["name"]: row["derived"] for row in json.load(f)["rows"]}
    gen = torch.Generator(device=DEVICE)
    b = 2.0 * torch.randn((K, ELASTIC_D), generator=gen.manual_seed(3),
                          device=DEVICE)
    x0 = torch.randn((1, ELASTIC_D), generator=gen.manual_seed(0),
                     device=DEVICE)

    def grads_fn(params, batch):
        g = {"w": params["w"] - b}
        return 0.5 * torch.sum(g["w"] ** 2, dim=-1).mean(), g

    kernels = counters()
    results, missed = {}, []
    for rate in ELASTIC_RATES:
        if rate == 0.0:
            events, ms = [], full_membership(K)
        else:
            events = chaos_script(K, ELASTIC_ROUNDS, seed=ELASTIC_SEED,
                                  kill_prob=rate, straggle_prob=rate)
            ms = membership_for(K, ELASTIC_ROUNDS, events)
        for name, kw in (("pd_sgdm", {}),
                         ("cpd_sgdm", {"gamma": 0.5,
                                       "compressor": SignCompressor()}),
                         ("mt_dsgdm", {}), ("qg_dsgdm", {})):
            opt = make_optimizer(name, DenseComm(ring(K), membership=ms,
                                                 device=DEVICE),
                                 eta=0.05, mu=0.9, p=ELASTIC_P,
                                 use_kernel=True, **kw)
            before = {n: fn.launches for n, fn in kernels.items()}
            t1 = time.perf_counter()
            run = run_dense_chaos(opt, events, {"w": x0.expand(K, -1)
                                                .contiguous()},
                                  grads_fn, ELASTIC_ROUNDS)
            seconds = time.perf_counter() - t1
            launched = {n: fn.launches - before[n]
                        for n, fn in kernels.items() if fn.launches
                        != before[n]}
            one = {"w": x0[0]}
            label = f"elastic/{name}_c{rate:g}"
            for r in range(ELASTIC_ROUNDS):
                check_round_matrix(opt.comm, r)
                want = oracle_fleet_bytes(opt, one, r)
                if run.accounted_bytes[r] != want:
                    missed.append(f"{label} round {r}: accounted "
                                  f"{run.accounted_bytes[r]} != {want}")
            total = float(run.accounted_bytes.sum())
            base = results.get((0.0, name), {}).get("mb_total",
                                                    total / 1e6) * 1e6
            saved = 1.0 - total / base if base else 0.0
            ratio = float(run.avg_loss[-1] / run.avg_loss[0])
            results[(rate, name)] = {
                "final_loss": float(run.avg_loss[-1]), "loss_ratio": ratio,
                "max_consensus": float(run.consensus.max()),
                "mb_total": total / 1e6, "bytes_saved_frac": saved}
            print(f"{label},{seconds / ELASTIC_ROUNDS * 1e6:.1f},"
                  f"final_loss={run.avg_loss[-1]:.4f};"
                  f"loss_ratio={ratio:.4f};"
                  f"max_consensus={run.consensus.max():.4f};"
                  f"mb_total={total / 1e6:.4f};"
                  f"bytes_saved_frac={saved:.4f}; launches {launched}")
            if not all(math.isfinite(v) for v in run.avg_loss):
                missed.append(f"{label}: loss {run.avg_loss}")
            ref = bench[label]
            if (round(total / 1e6, 4) != ref["mb_total"]
                    or round(saved, 4) != ref["bytes_saved_frac"]):
                missed.append(f"{label}: mb_total {total / 1e6}, saved "
                              f"{saved} against BENCH_elastic.json's {ref}")
    bounded = int(all(
        v["final_loss"] <= 2.0 * results[(0.0, name)]["final_loss"]
        and v["max_consensus"] <= 5.0 * results[(0.0, name)]["max_consensus"]
        for (rate, name), v in results.items() if rate > 0.0))
    top_saved = results[(max(ELASTIC_RATES), "pd_sgdm")]["bytes_saved_frac"]
    print(f"elastic/claim_survivors,0.0,survivors_bounded={bounded};"
          f"cells={len(results)}")
    print(f"elastic/claim_bytes,0.0,bytes_saved_frac={top_saved:.4f};"
          f"rate={max(ELASTIC_RATES):g}")
    if not bounded:
        missed.append("survivors_bounded = 0")
    if round(top_saved, 4) != bench["elastic/claim_bytes"]["bytes_saved_frac"]:
        missed.append(f"bytes_saved_frac {top_saved}")
    verdict("elastic", missed, t0)


def topology_phase(torch):
    """``benchmarks/topology_sweep.py``'s equal-bytes claim on the card:
    K = 16 workers, worker k's loss ``0.5·mean((x − c_k)²)`` with targets
    ``base + 3·offset`` (D = 64, from the card's generator, seeds 3 and
    4), PD-SGDM at η = 0.2, μ = 0.9, p = 4 from x = 0 through
    ``SimTrainer``; the static ring for 96 steps against the one-peer
    exponential schedule for 192, on the tree layout (the sweep's) and on
    the kernel layout.  Held: on the tree layout both runs ship the same
    comm-MB exactly, and on both layouts the one-peer consensus
    (mean_k ‖x_k − x̄‖) is below half the ring's.  On the kernel layout the
    ring's neighbour views ship a whole 1024-lane row per 64-float leaf
    (4,096 B a neighbour against 256 B), so its comm-MB is printed, not
    held equal."""
    from repro_torch.core import DenseComm, PDSGDM, PDSGDMConfig
    from repro_torch.core.topology import (one_peer_exponential_schedule,
                                           ring, static_schedule)
    from repro_torch.train.trainer import SimTrainer
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    base = torch.randn((TOPO_D,), generator=gen.manual_seed(3),
                       device=DEVICE)
    offs = torch.randn((TOPO_K, TOPO_D), generator=gen.manual_seed(4),
                       device=DEVICE) * 3.0
    batch = {"y": base[None, :] + offs}

    def loss_fn(params, b):
        return 0.5 * torch.mean((params["x"] - b["y"]) ** 2), {}

    kernels = counters()
    missed, got = [], {}
    for use_kernel in (False, True):
        layout = "kernel" if use_kernel else "tree"
        for name, sched, steps in (
                ("static_ring", static_schedule(ring(TOPO_K)), TOPO_STEPS),
                ("one_peer_exp", one_peer_exponential_schedule(TOPO_K),
                 2 * TOPO_STEPS)):
            opt = PDSGDM(PDSGDMConfig(eta=TOPO_ETA, mu=0.9, p=P,
                                      use_kernel=use_kernel),
                         DenseComm(sched, device=DEVICE))
            before = {n: fn.launches for n, fn in kernels.items()}
            t1 = time.perf_counter()
            params, _, hist = SimTrainer(
                loss_fn, opt, device=DEVICE,
                rounds_per_log=steps // P).train(
                    {"x": torch.zeros((TOPO_K, TOPO_D), device=DEVICE)},
                    lambda t: batch, steps, log_every=steps)
            seconds = time.perf_counter() - t1
            launched = {n: fn.launches - before[n]
                        for n, fn in kernels.items()
                        if fn.launches != before[n]}
            x = params["x"].double().cpu()
            consensus = float((x - x.mean(0)).norm(dim=1).mean())
            got[(layout, name)] = (consensus, hist.comm_mb[-1])
            print(f"topology_sweep/{name} ({layout} layout, {steps} steps),"
                  f"{seconds / steps * 1e6:.1f},consensus={consensus:.4f};"
                  f"comm_mb={hist.comm_mb[-1]:.6f};"
                  f"cycle_rho={opt.comm.schedule.cycle_rho:.4f}; "
                  f"launches {launched}")
            if not math.isfinite(consensus):
                missed.append(f"{layout} {name}: consensus {consensus}")
        ring_c, ring_mb = got[(layout, "static_ring")]
        peer_c, peer_mb = got[(layout, "one_peer_exp")]
        print(f"topology_sweep/equal_bytes_one_peer_exp ({layout} layout),"
              f"0.0,comm_mb={peer_mb:.6f};consensus={peer_c:.4f};"
              f"consensus_ring_same_mb={ring_c:.4f};"
              f"ring_over_one_peer={ring_c / peer_c:.2f}")
        if not peer_c < 0.5 * ring_c:
            missed.append(f"{layout}: one-peer consensus {peer_c} >= half "
                          f"the ring's {ring_c}")
        if not use_kernel and peer_mb != ring_mb:
            missed.append(f"comm_mb {peer_mb} != {ring_mb}")
    verdict("topology", missed, t0)


def gossip_dispatch_phase(torch):
    """One kernel round each of PD on the ring and on exponential(16), MT
    and QG, PD on the bf16 wire, and overlapped PD and MT (whose gossip is
    the stale mix) under the CPU profiler, with the optimizer's ``_gossip_mat``
    run inside a ``record_function`` range: the gossip steps dispatch no
    ``aten::roll`` and no ``aten::constant_pad_nd`` (the views are read in
    place), and the round no ``aten::roll`` at all (the ResNet's stride-2
    convolutions pad, outside the gossip)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for path, steps in (("pd_sgdm", 1), ("pd_sgdm_exp16", 1),
                        ("mt_dsgdm", 2), ("qg_dsgdm", 1), ("pd_sgdm_bf16", 1),
                        ("pd_sgdm_overlap", 1), ("mt_dsgdm_overlap", 2)):
        opt = make_opt(path, use_kernel=True)
        gossip = opt._gossip_mat

        def traced(*args, _gossip=gossip, **kwargs):
            with record_function("gossip_step"):
                return _gossip(*args, **kwargs)

        opt._gossip_mat = traced
        drive(torch, opt, path, 0, P)                  # warm-up round
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            drive(torch, opt, path, 0, P)
            torch.cuda.synchronize()
        events = prof.events()

        def in_step(e):
            while e.cpu_parent is not None:
                e = e.cpu_parent
                if e.name == "gossip_step":
                    return True
            return False

        seen = sum(1 for e in events if e.name == "gossip_step")
        counts = {name: (sum(1 for e in events if e.name == name
                             and in_step(e)),
                         sum(1 for e in events if e.name == name))
                  for name in ("aten::roll", "aten::constant_pad_nd")}
        print(f"profile: {path} round: {seen} gossip steps; aten::roll "
              f"{counts['aten::roll'][0]} in them, {counts['aten::roll'][1]} "
              f"in the round; aten::constant_pad_nd "
              f"{counts['aten::constant_pad_nd'][0]} in them, "
              f"{counts['aten::constant_pad_nd'][1]} in the round")
        if (seen != steps or counts["aten::roll"][1]
                or counts["aten::constant_pad_nd"][0]):
            raise AssertionError(f"{path}: the gossip copies its views "
                                 f"({seen} steps, {counts})")


def dev_us(e) -> float:
    """Device time (µs) of a profiler ``key_averages()`` entry."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def gather_in_round(torch, variants, rounds: int = 8):
    """The gather's per-launch device time in the sparse path's rounds:
    ``rounds`` steady-state rounds under the profiler (one gather each),
    for the checkout's kernel and each of ``variants``, in four turns
    (forward, backward, forward, backward); the mean of the turns.  At the
    path's budget of S = 64 rows a worker, and at S = 1,024 (a budget a
    user may set with ``--compressor-rows``; more bytes on the wire, so a
    design check and not the path).  Beside it, the round's shortest
    kernel per launch: what the profiler reads for a kernel that does
    next to nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    path = "cpd_sgdm_sparse"
    names = ("row_gather_kernel", "row_gather_rows_kernel")
    binds = [("kernel", None)] + list(variants)
    for s in (EMB_MAX_ROWS, GATHER_WIDE_S):
        opt = make_opt(path, use_kernel=True, max_rows=s)
        got = {label: [] for label, _ in binds}
        floor = []
        for order in (binds, binds[::-1]) * 2:
            for label, fn in order:
                with bound_gather(fn):
                    drive(torch, opt, path, 0, P)        # warm-up round
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        drive(torch, opt, path, 0, P * rounds)
                        torch.cuda.synchronize()
                events = [e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.count]
                floor.append(min(
                    (dev_us(e) / e.count, e.key[:60]) for e in events
                    if not e.key.startswith(("Memcpy", "Memset"))))
                hits = [e for e in events if any(n in e.key for n in names)]
                if sum(e.count for e in hits) != rounds:
                    raise AssertionError(f"gather_in_round: {label}: "
                                         f"{[(e.key, e.count) for e in hits]}")
                got[label].append(sum(dev_us(e) for e in hits) / rounds)
        print(f"profile: row_gather in the {path} round at S={s}, per "
              f"launch over {rounds} rounds, four turns: " + "; ".join(
                  f"{label} {statistics.mean(v):.3f} us "
                  f"({', '.join(f'{t:.3f}' for t in v)})"
                  for label, v in got.items()))
        print(f"profile: the shortest kernel of those rounds, per launch: "
              f"{statistics.mean(f for f, _ in floor):.3f} us "
              f"({min(floor)[1]})")


def gradient_peak(torch, path: str):
    """The device memory one step's gradient of a full-width path takes
    above its K workers' params: the peak of ``vmap(grad_and_value)`` on
    step 0's batch, less the params, with the grads it returns."""
    gc.collect()
    torch.cuda.empty_cache()
    params = lm_init(torch, path, 0)
    batch = lm_stream(path, 0)(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, grads = lm_grads_fn(torch, path)(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    copy = sum(v.numel() * v.element_size() for v in params.values())
    print(f"profile: {path} one step's gradient: peak {peak / 2**20:.1f} "
          f"MiB above the params ({peak / copy:.2f} copies of "
          f"{copy / 2**20:.1f} MiB), {held / 2**20:.1f} MiB held after "
          f"(the grads)")
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()


def profile_round(torch, path: str):
    """Profile one steady-state round of ``path``; the table goes to
    ``round_profile_<path>.txt`` in the output directory.  A full-width
    path also prints :func:`gradient_peak`."""
    from torch.profiler import ProfilerActivity, profile
    if path in FULL_WIDTH:
        gradient_peak(torch, path)
    opt = make_opt(path, use_kernel=True)
    drive(torch, opt, path, 0, P)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(torch, opt, path, 0, P)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"round_profile_{path}.txt"), "w") as f:
        f.write(events.table(sort_by=sort_key, row_limit=60))
    print(f"profile: {path} one round {wall * 1e3:.2f} ms wall under the "
          f"profiler, kernels {busy * 1e3:.2f} ms on the device")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    for name in ("momentum_kernel", "momentum_inplace_kernel",
                 "gossip_mix_kernel",
                 "gossip_mix_tile_kernel", "sign_pack_kernel",
                 "sign_unpack_kernel", "qsgd_quant_kernel",
                 "qsgd_dequant_kernel", "topk_select_kernel",
                 "topk_scatter_kernel", "row_gather_kernel",
                 "row_gather_rows_kernel", "row_scatter_kernel"):
        hits = [e for e in kernels if name in e.key]
        if hits:
            print(f"profile:   {name}: " + ", ".join(
                f"{dev_us(e) / e.count:.2f} us x{e.count}" for e in hits))


# ----------------------------------------------------------- sharded paths
# The sharded runtime (ShardedComm / HierarchicalComm through build_train
# and ShardedTrainer) in ranks spawned on this one card: each rank a
# process on cuda:0, joined by a gloo group whose wire goes through host
# buffers (NCCL puts no two ranks on one device).  Its s/round is gloo's
# host-staged loopback, not an interconnect's speed.
SHARDED_OLMO_K = 4          # ~9.6 GiB a rank at OLMo-1B's one layer (PERF.md §4)
SHARDED_ROUNDS = 2
HIER_SIGN = (2, 2)          # hierarchical(2, 2): 2 nodes of 2 ranks
RESUME_K, RESUME_K2, RESUME_STEPS = 4, 6, 12
RESUME_STOPS = (6, 8)       # off a round boundary, and on one
ROUND_BAR = dict(rtol=1e-3, atol=1e-4)    # the kernel-round bar
GATHER_TAG = 1 << 22        # the tag of ``gather_to_root``'s messages


def rank_setup(torch, dev):
    """A rank's card settings, as ``main`` sets the parent's: no TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spawn(fn, n: int, *args) -> list:
    """``fn((rank, world, device), *args)`` in ``n`` gloo ranks on the card;
    a rank that raises fails the call (nothing is caught)."""
    from repro_torch.launch.spawn import spawn_ranks
    return spawn_ranks(fn, n, args, backend="gloo", device=DEVICE)


# Sharded phases whose ranks share one spawn: a run that chooses several
# phases of one world size spawns those ranks once, at the first of them,
# and each rank runs the phases' rank functions in turn (``shared_rank``);
# each phase then holds its own results.  A spawn of rank processes takes
# 15-40 s on the card's host before any work, and the ten sharded phases
# here would take ten of them.
SHARED_RESULTS = {}     # phase -> its ranks' results, until the phase runs
CHOSEN = ()             # the phases this invocation runs (``main``)


def shared_tasks() -> dict:
    """``{phase: (world, rank function, its arguments)}`` of the phases
    that share a spawn with the others of their world size."""
    def split_world(path):
        sizes, _, model_axis = SPLIT[path]["mesh"]
        return math.prod(sizes) * model_axis
    return {
        "sharded_olmo1b": (SHARDED_OLMO_K, sharded_olmo_rank, ()),
        "sharded_resnet_pd": (K, sharded_resnet_rank, (0,)),
        "sharded_tinylm_hier_sign": (HIER_SIGN[0] * HIER_SIGN[1],
                                     sharded_hier_rank, ()),
        "sharded_olmo1b_cpd_sign": (SHARDED_OLMO_K, sharded_cpd_olmo_rank,
                                    ()),
        "sharded_resnet_cpd": (K, sharded_codec_rank,
                               (tuple(CODEC_PATHS), 0)),
        "sharded_embedding_cpd_sparse": (EMB_K, sharded_embedding_rank,
                                         (0,)),
        "sharded_olmo1b_tp2": (TP_K * TP_AXIS, tp_dp_rank, ()),
        "sharded_qwen2_72b_fsdp": (split_world("sharded_qwen2_72b_fsdp"),
                                   split_rank, (["sharded_qwen2_72b_fsdp"],)),
        "sharded_mla_ssd_tp2": (split_world("sharded_mla_tp2"), split_rank,
                                (["sharded_mla_tp2", "sharded_ssd_tp2"],)),
        "serve_sharded_olmo1b": (4, serve_sharded_rank,
                                 (serve_sharded_prompt().numpy(),)),
    }


def shared_rank(mesh_rank, tasks):
    """The rank functions of ``tasks`` (``[(phase, fn, args)]``) in turn in
    this rank, each from a freed card, cuDNN's determinism and TF32 reset
    to the rank's start: ``({phase: result}, {phase: seconds})``."""
    import torch
    import torch.distributed as dist
    rank, world, dev = mesh_rank
    out, secs = {}, {}
    for phase, fn, args in tasks:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        torch.backends.cudnn.deterministic = False
        rank_setup(torch, dev)
        dist.barrier()
        t0 = time.perf_counter()
        out[phase] = fn(mesh_rank, *args)
        secs[phase] = time.perf_counter() - t0
    dist.barrier()
    return out, secs


def spawn_shared(phase: str) -> list:
    """The ranks' results of ``phase``: from the spawn it shares with the
    other chosen phases of its world size (spawned here when it is the
    first of them to run)."""
    if phase not in SHARED_RESULTS:
        tasks = shared_tasks()
        world = tasks[phase][0]
        names = [n for n in PHASES if n in tasks and tasks[n][0] == world
                 and (n == phase or (n in CHOSEN
                                     and list(PHASES).index(n) >
                                     list(PHASES).index(phase)))]
        t0 = time.perf_counter()
        ranks = spawn(shared_rank, world,
                      [(n, tasks[n][1], tasks[n][2]) for n in names])
        print(f"sharded: one spawn of {world} ranks for {', '.join(names)}: "
              f"{time.perf_counter() - t0:.1f} s; the ranks' seconds "
              + ", ".join(f"{n} {max(r[1][n] for r in ranks):.1f}"
                          for n in names))
        for n in names:
            SHARED_RESULTS[n] = [r[0][n] for r in ranks]
    return SHARED_RESULTS.pop(phase)


def reset_counters() -> dict:
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    return kernels


def lm_run(path: str, *, inter_codec="none", node_size=0,
           hyper=FULL_HYPER):
    """The RunCfg of an LM path on the sharded runtime, kernel layout, with
    the reference's default ``remat="full"``."""
    from repro_torch.configs.base import OptimCfg, ParallelCfg, RunCfg
    return RunCfg(model=lm_model(path).cfg,
                  parallel=ParallelCfg(profile="A", topology="ring",
                                       node_size=node_size,
                                       inter_codec=inter_codec),
                  optim=OptimCfg(name="pd_sgdm", use_kernel=True,
                                 weight_decay=hyper.get("weight_decay", 0.0),
                                 **{k: v for k, v in hyper.items()
                                    if k != "weight_decay"}))


def worker_stream(path: str, world: int, seed: int = 0):
    """The dense stream of ``world`` workers (all K drawn, as ``lm_batch``
    draws them for ``SimTrainer``)."""
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    seq, batch = seq_batch(path)
    cfg = LMStreamCfg(vocab=lm_model(path).cfg.vocab, seq_len=seq,
                      batch=batch, n_workers=world, seed=seed)
    return lambda t: lm_batch(cfg, t, DEVICE)


def watch_rounds(torch, pack, rounds: list, keep: bool = True):
    """Wrap ``pack.train_round``: per round its wall (the card synchronized
    on both sides), launches, bytes handed to isend and to all_reduce,
    and (``keep``) the params and state it started from and its result."""
    inner = pack.train_round
    comm = pack.opt.comm

    def train_round(params, state, batches, t):
        kernels = counters()
        before = {n: f.launches for n, f in kernels.items()}
        comm.sent_bytes = comm.reduced_bytes = 0
        sync(torch, comm.device)
        t0 = time.perf_counter()
        out = inner(params, state, batches, t)
        sync(torch, comm.device)
        rounds.append({
            "s": time.perf_counter() - t0, "t": t,
            "launches": {n: f.launches - before[n]
                         for n, f in kernels.items()},
            "sent": comm.sent_bytes, "reduced": comm.reduced_bytes})
        if keep:
            rounds[-1].update(start=(params, state), end=out[0],
                              end_state=out[1])
        return out
    pack.train_round = train_round


def gather_to_root(torch, t):
    """``t`` (this rank's, on the card) gathered to rank 0 through the host,
    stacked on the worker dim; None on the other ranks.  Point to point:
    gloo's ``gather`` moves a sixth of the bytes a second."""
    import torch.distributed as dist
    t = t.detach().cpu().contiguous()
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank != 0:
        dist.isend(t, 0, tag=GATHER_TAG).wait()
        return None
    bufs = [t] + [torch.empty_like(t) for _ in range(1, world)]
    for q in [dist.irecv(bufs[r], r, tag=GATHER_TAG)
              for r in range(1, world)]:
        q.wait()
    return torch.cat(bufs)


def dense_round(torch, path, opt, params, state, stream, t0):
    """One dense kernel round of ``opt`` (a ``DenseComm``) from ``params``
    and ``state`` on the steps of ``stream`` from ``t0``: what
    ``SimTrainer`` runs."""
    from repro_torch.train.trainer import _stack_batches
    batches = _stack_batches([stream(t0 + i) for i in range(P)])
    params, state, _ = opt.round(state, params, lm_grads_fn(torch, path),
                                 batches)
    return params, state


def sharded_olmo_rank(mesh_rank):
    """A rank of ``sharded_olmo1b``: two rounds of its worker through
    ``ShardedTrainer``, then (rank 0) the checks against the dense
    backend, with the other ranks' matrices gathered through the host."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    path = "pd_sgdm_olmo1b"
    pack = build_train(lm_run(path), make_mesh((world,), ("w",), device=dev))
    opt = pack.opt
    stream = worker_stream(path, world)
    grab = []
    inner = opt._gossip_mat

    def gossip_mat(x_mat, r, *, plan=None):
        y = inner(x_mat, r, plan=plan)
        if not grab:                      # round 0's input and output
            grab.extend([x_mat, y])
        return y
    opt._gossip_mat = gossip_mat
    rounds = []
    watch_rounds(torch, pack, rounds)
    trainer = ShardedTrainer(pack)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    out = trainer.train(0, lambda t: pack.worker_batch(stream(t)),
                        SHARDED_ROUNDS * P, log_every=P, verbose=False)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    cycle = trainer.bytes_per_round_cycle()
    plan = kops.KernelPlan.for_tree(out["params"], worker_dim=True)
    stats = {"rank": rank, "peak_mib": peak / 2 ** 20,
             "s_per_round": [r["s"] for r in rounds],
             "launches": [r["launches"] for r in rounds],
             "sent": [r["sent"] for r in rounds], "cycle": cycle,
             "used": plan.used_rows, "rows": plan.rows,
             "losses": out["history"].loss}
    # to the host, then the card freed for rank 0's dense rounds
    x_in, y0 = (grab[0].cpu(), grab[1].cpu())
    m0 = plan.flatten(rounds[1]["start"][1]["m"]).cpu()
    y1 = plan.flatten(out["params"]).cpu()
    del grab[:], rounds[:], out, opt, pack, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    x_all = gather_to_root(torch, x_in)
    y0_all = gather_to_root(torch, y0)
    m0_all = gather_to_root(torch, m0)
    y1_all = gather_to_root(torch, y1)
    del x_in, y0, m0, y1
    if rank != 0:
        dist.barrier()
        return stats
    # (1) round 0's gossip, bit for bit the dense shifted step on the
    # stacked matrices
    top = ring(world)
    x = x_all.to(dev)
    dense_y = kops.gossip_mix_shifted(
        x, grid=top.axis_sizes, axis=0, shifts=[s for (_, s, _) in
                                                top.shifts],
        weights=[w for (_, _, w) in top.shifts], lim=stats["used"])
    stats["gossip_bitwise"] = bool(torch.equal(dense_y.cpu(), y0_all))
    del x, dense_y, x_all
    # (2) each round against DenseComm's kernel round from the same start
    dopt = make_optimizer("pd_sgdm", DenseComm(ring(world), device=dev),
                          use_kernel=True, **FULL_HYPER)
    one = lm_model(path).init(torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    params = {n: v.expand((world,) + v.shape).contiguous()
              for n, v in one.items()}
    del one
    gaps = []
    for rnd, (start_x, start_m, want) in enumerate(
            ((None, None, y0_all), (y0_all, m0_all, y1_all))):
        if start_x is None:
            state = dopt.init(params)
        else:
            dplan = kops.KernelPlan.for_tree(params, worker_dim=True)
            params = dplan.unflatten(start_x.to(dev))
            state = {"m": dplan.unflatten(start_m.to(dev)),
                     "step": torch.tensor(rnd * P, dtype=torch.int32,
                                          device=dev)}
        params, state = dense_round(torch, path, dopt, params, state,
                                    stream, rnd * P)
        dplan = kops.KernelPlan.for_tree(params, worker_dim=True)
        got = want.to(dev)
        dense = dplan.flatten(params)
        gaps.append(float((dense - got).abs().max()))
        if not torch.allclose(got, dense, **ROUND_BAR):
            stats.setdefault("round_missed", []).append(rnd)
        del state, got, dense
    stats["round_gaps"] = gaps
    dist.barrier()
    return stats


def sharded_olmo_phase(torch):
    """``sharded_olmo1b``: PD-SGDM at OLMo-1B's published widths (one of 16
    layers, f32) in 4 ranks on the card, ring, seq 256, batch 2 a worker,
    the kernel layout: two rounds through ``ShardedTrainer``; each rank p
    momentum and 1 gossip launches a round and hands ``isend``
    2 × used rows × 4 KiB; round 0's gossip bit for bit the dense shifted
    step; each round within the kernel-round bar of ``DenseComm``'s from
    the same start."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats = spawn_shared("sharded_olmo1b")
    wall = time.perf_counter() - t0
    root = stats[0]
    from repro_torch.kernels import LANE
    want = (2 * root["used"] * LANE * 4,)
    print(f"sharded: sharded_olmo1b {describe('pd_sgdm_olmo1b')}, "
          f"K={SHARDED_OLMO_K} ranks on one card (gloo), ring, p={P}, "
          f"{SHARDED_ROUNDS} rounds through ShardedTrainer, {wall:.1f} s "
          "with the spawn and the checks")
    print(f"sharded: sharded_olmo1b losses (the ranks' mean) "
          + " ".join(f"{v:.4f}" for v in root["losses"]))
    for s in stats:
        print(f"sharded: sharded_olmo1b rank {s['rank']}: peak "
              f"{s['peak_mib']:.1f} MiB, s/round (gloo's host-staged wire) "
              + ", ".join(f"{v:.4f}" for v in s["s_per_round"])
              + f", launches {s['launches']}, isend bytes {s['sent']}")
    print(f"sharded: sharded_olmo1b peak summed over the ranks "
          f"{sum(s['peak_mib'] for s in stats):.1f} MiB; round 0's gossip "
          f"bit for bit the dense step: {root['gossip_bitwise']}; max "
          f"|Δparam| against DenseComm per round {root['round_gaps']}")
    for s in stats:
        for lc in s["launches"]:
            if lc != {**{n: 0 for n in lc}, "momentum_update": P,
                      "gossip_mix": 1}:
                raise AssertionError(f"sharded_olmo1b: launches {lc}")
        if tuple(s["cycle"]) != want or s["sent"] != list(
                want) * SHARDED_ROUNDS:
            raise AssertionError(f"sharded_olmo1b: isend bytes {s['sent']},"
                                 f" cycle {s['cycle']}, expected {want}")
    if not root["gossip_bitwise"]:
        raise AssertionError("sharded_olmo1b: round 0's gossip differs from "
                             "the dense shifted step")
    if root.get("round_missed") or not all(
            math.isfinite(v) for v in root["losses"]):
        raise AssertionError(f"sharded_olmo1b: rounds {root.get('round_missed')}"
                             f" past the bar, losses {root['losses']}")
    return stats


def sharded_resnet_rank(mesh_rank, seed: int):
    """A rank of ``sharded_resnet_pd``: ResNet-20's worker through a
    ``TrainPack`` of its own and ``ShardedTrainer``, 14 steps."""
    import torch
    from repro_torch.core import ShardedComm, make_optimizer, ring
    from repro_torch.launch.mesh import make_layout, make_mesh
    from repro_torch.launch.runtime import (TrainPack, check_state_keys,
                                            make_steps)
    from repro_torch.models.resnet import resnet20_init, resnet20_loss
    from repro_torch.train.trainer import ShardedTrainer
    from repro_torch.configs.base import ParallelCfg
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh((world,), ("w",), device=dev)
    opt = make_optimizer("pd_sgdm", ShardedComm(ring(world), axis_names=("w",),
                                                mesh=mesh),
                         use_kernel=True, **HYPER)
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: resnet20_loss(p, b)[0]))

    def gfn(params, batch):
        g, losses = grad(params, batch)
        return losses.mean(), g

    def init_fn(s):
        gen = torch.Generator(device=dev).manual_seed(s)
        params = {n: v.unsqueeze(0) for n, v in
                  resnet20_init(gen, width=WIDTH, device=dev).items()}
        return params, opt.init(params)

    train_step, train_round = make_steps(opt, gfn)

    struct = {n: torch.empty((1,) + tuple(v.shape[1:]), device="meta")
              for n, v in stacked_init(torch, seed, 1).items()}
    pack = TrainPack(model=None, opt=opt,
                     layout=make_layout(ParallelCfg(), mesh), device=dev,
                     params_struct=struct, state_struct=opt.init(struct),
                     state_keys=check_state_keys(opt.init(struct)),
                     init_fn=init_fn, train_step=train_step,
                     train_round=train_round)
    stream = batch_fn(seed, world)
    rounds = []
    watch_rounds(torch, pack, rounds)
    kernels = reset_counters()
    out = ShardedTrainer(pack).train(seed, lambda t: pack.worker_batch(
        stream(t)), STEPS, log_every=1, verbose=False)
    sync(torch, dev)

    def host(tree):
        return {n: v.cpu() for n, v in tree.items()}
    return {"launches": {n: f.launches for n, f in kernels.items()},
            "sent": sum(r["sent"] for r in rounds),
            "cycle": ShardedTrainer(pack).bytes_per_round_cycle(),
            "rounds": [(host(r["start"][0]), host(r["start"][1]["m"]),
                        host(r["end"]), host(r["end_state"]["m"]), r["t"])
                       for r in rounds],
            "params": host(out["params"]), "losses": out["history"].loss}


def resnet_grads_fn(torch, per_worker: bool = False):
    """``SimTrainer``'s gradients of ResNet-20 over the stacked workers; with
    ``per_worker`` one worker at a time (a vmap over 1, the shapes a rank's
    convolutions see), concatenated."""
    from repro_torch.models.resnet import resnet20_loss
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: resnet20_loss(p, b)[0]))

    def grads_fn(params, batch):
        if not per_worker:
            g, losses = grad(params, batch)
            return losses.mean(), g
        k = next(iter(params.values())).shape[0]
        outs = [grad({n: v[i:i + 1] for n, v in params.items()},
                     {n: v[i:i + 1] for n, v in batch.items()})
                for i in range(k)]
        g = {n: torch.cat([o[0][n] for o in outs]) for n in params}
        return torch.cat([o[1] for o in outs]).mean(), g
    return grads_fn


def sharded_resnet_phase(torch):
    """``sharded_resnet_pd``: the paper's main path, ResNet-20 width 16 at
    the ``pd_sgdm`` path's settings, K = 8 ranks on the ring, 14 steps
    (3 rounds and a 2-step tail), held against the dense ``pd_sgdm`` path:
    each rank the dense run's launches and bytes, and each round (and the
    tail) within the kernel-round bar of the dense round from the same
    start, its gradients taken worker by worker (a rank's convolutions see
    a vmap over 1 worker, the dense run's over 8, and round 0 from the
    init is chaotic enough at this step to part the two by more than the
    bar: that gap, against the dense round's own vmap over 8, is printed
    beside)."""
    from repro_torch.train.trainer import _stack_batches
    t0 = time.perf_counter()
    stats = spawn_shared("sharded_resnet_pd")
    wall = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = True
    opt = make_opt("pd_sgdm", True)
    stream = batch_fn(0, K)

    def stacked(i, j):
        return {n: torch.cat([s["rounds"][i][j][n] for s in stats]).to(DEVICE)
                for n in stats[0]["rounds"][i][j]}

    gaps = []
    n_rounds = len(stats[0]["rounds"])
    for i in range(n_rounds + 1):
        if i < n_rounds:
            t, (x0, m0), want = (stats[0]["rounds"][i][4],
                                 (stacked(i, 0), stacked(i, 1)),
                                 stacked(i, 2))
            steps = P
        else:                           # the tail: local steps only
            t = n_rounds * P
            x0, m0 = stacked(i - 1, 2), stacked(i - 1, 3)
            want = {n: torch.cat([s["params"][n] for s in stats]).to(DEVICE)
                    for n in x0}
            steps = STEPS - t
        state = {"m": m0, "step": torch.tensor(t, dtype=torch.int32,
                                               device=DEVICE)}
        batches = _stack_batches([stream(t + k) for k in range(steps)])
        gap = []
        for per_worker in (True, False):
            got, _, _ = opt.round(dict(state), x0,
                                  resnet_grads_fn(torch, per_worker),
                                  batches, gossip=steps == P)
            gap.append(max(float((got[n] - want[n]).abs().max())
                           for n in got))
            if per_worker:
                held = got
        gaps.append(tuple(gap))
        got = held
        for n in got:
            if not torch.allclose(want[n], got[n], **ROUND_BAR):
                raise AssertionError(f"sharded_resnet_pd: round {i}'s {n} "
                                     "differs from the dense round")
    torch.backends.cudnn.deterministic = False
    print(f"sharded: sharded_resnet_pd ResNet-20 width {WIDTH}, batch "
          f"{BATCH}, K={K} ranks on one card (gloo), ring, {STEPS} steps "
          f"through ShardedTrainer, {wall:.1f} s with the spawn; losses "
          + " ".join(f"{v:.4f}" for v in stats[0]["losses"]))
    print(f"sharded: sharded_resnet_pd launches per rank "
          f"{stats[0]['launches']}, isend bytes per rank "
          f"{[s['sent'] for s in stats]}, max |Δparam| against the dense "
          f"round from the same start (its grads worker by worker; over the "
          f"vmap of 8), per round and the tail {gaps}")
    want = {name: EXPECTED["pd_sgdm"].get(name, 0) for name in counters()}
    rounds = STEPS // P
    for s in stats:
        if s["launches"] != want:
            raise AssertionError(f"sharded_resnet_pd: launches "
                                 f"{s['launches']}, expected {want}")
        if (tuple(s["cycle"]) != WIRE_BYTES["pd_sgdm"]
                or s["sent"] != rounds * WIRE_BYTES["pd_sgdm"][0]):
            raise AssertionError(f"sharded_resnet_pd: {s['sent']} B sent")


def plain_hier_sign_mix(torch, x_mat, used: int):
    """The plain two-level round of ``hierarchical(2, 2)`` with the sign
    codec on the stacked matrix: node means, the inter factor's self term
    on the mean, the other node's mean (cut to the used rows) through the
    plain per-leaf sign codec, the result on every member."""
    from repro_torch.core import SignCompressor, hierarchical
    from repro_torch.core.topology import (hierarchical_inter_shifts,
                                           hierarchical_self_weight)
    from repro_torch.core.wire import make_codec
    codec = make_codec(SignCompressor(block=1024))
    top = hierarchical(*HIER_SIGN)
    n, m = HIER_SIGN
    xa = x_mat.reshape((n, m) + tuple(x_mat.shape[1:])).mean(dim=1)
    acc = xa * float(hierarchical_self_weight(top))
    for (sh, w) in hierarchical_inter_shifts(top):
        dec = []
        for i in range(n):
            src = xa[(i + sh) % n][:used].contiguous()
            q = codec.unpack(codec.pack(src.cpu()), src.numel(), src.shape,
                             torch.float32).to(src.device)
            dec.append(torch.nn.functional.pad(q, (0, 0, 0, x_mat.shape[1]
                                                   - used)))
        acc = acc + torch.stack(dec) * float(w)
    return acc.repeat_interleave(m, dim=0)


def sharded_hier_rank(mesh_rank):
    """A rank of ``sharded_tinylm_hier_sign``: the tiny LM on
    ``HierarchicalComm`` (flat axis, 2 nodes × 2) with the sign inter
    codec, 3 rounds; each round's start and result gathered to rank 0,
    which holds it against the dense round."""
    import torch
    from repro_torch.core import DenseComm, hierarchical, make_optimizer
    from repro_torch.core.gossip import hier_bytes_per_round
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train, per_worker
    from repro_torch.train.trainer import ShardedTrainer
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    path = "pd_sgdm_tinylm_hier"
    pack = build_train(lm_run(path, inter_codec="sign", node_size=HIER_SIGN[1],
                              hyper=TINY_HYPER),
                       make_mesh((world,), ("w",), device=dev))
    rounds = []
    watch_rounds(torch, pack, rounds)
    stream = worker_stream(path, world)
    reset_counters()
    ShardedTrainer(pack).train(0, lambda t: pack.worker_batch(stream(t)),
                               3 * P, log_every=P, verbose=False)
    plan = kops.KernelPlan.for_tree(rounds[0]["end"], worker_dim=True)
    levels = hier_bytes_per_round(torch.empty(
        (plan.used_rows * kops.LANE,), device="meta"), pack.opt.comm)
    stats = {"rank": rank, "launches": [r["launches"] for r in rounds],
             "sent": [r["sent"] for r in rounds],
             "reduced": [r["reduced"] for r in rounds], "levels": levels,
             "cycle": ShardedTrainer(pack).bytes_per_round_cycle(),
             "bytes_model": pack.opt.hier_bytes_per_level(
                 per_worker(pack.params_struct)),
             "rows": (plan.rows, plan.used_rows)}
    gathered = [(gather_to_root(torch, plan.flatten(r["start"][0])),
                 gather_to_root(torch, plan.flatten(r["start"][1]["m"])),
                 gather_to_root(torch, plan.flatten(r["end"])), r["t"])
                for r in rounds]
    if rank != 0:
        return stats
    dopt = make_optimizer("pd_sgdm", DenseComm(hierarchical(*HIER_SIGN),
                                               device=dev),
                          use_kernel=True, **TINY_HYPER)
    gaps = []
    for (x0, m0, want, t) in gathered:
        params = plan.unflatten(x0.to(dev))
        state = {"m": plan.unflatten(m0.to(dev)),
                 "step": torch.tensor(t, dtype=torch.int32, device=dev)}
        from repro_torch.train.trainer import _stack_batches
        batches = _stack_batches([stream(t + i) for i in range(P)])
        params, state, _ = dopt.round(state, params,
                                      lm_grads_fn(torch, path), batches,
                                      gossip=False)
        # the leaves' elements: a decoded pad element is no param
        dense = plan.flatten(plan.unflatten(plain_hier_sign_mix(
            torch, plan.flatten(params), plan.used_rows)))
        got = want.to(dev)
        gap = (dense - got).abs()
        far = ~torch.isclose(got, dense, **ROUND_BAR)
        # a node mean within an ulp of 0 may take the other sign on the
        # two sides: its element moves by 2·scale·w, bounded by 2·max|x|
        flips = int(far.sum())
        gaps.append((float(gap.max()), flips))
        if flips > 8 or not bool(
                (gap[far] <= 2 * float(dense.abs().max())).all()):
            stats.setdefault("round_missed", []).append(t // P)
    stats["round_gaps"] = gaps
    return stats


def sharded_hier_phase(torch):
    """``sharded_tinylm_hier_sign``: the tiny LM on ``HierarchicalComm``
    (flat axis, hierarchical(2, 2)) with ``inter_codec="sign"`` on the
    kernel layout, 4 ranks, 3 rounds: ``sign_pack`` and ``sign_unpack``
    on every rank, the inter bytes on the leaders only and the all_reduce
    bytes as ``hier_bytes_per_round`` has them, each round held against
    the dense round (``DenseComm`` on hierarchical(2, 2), the plain sign
    codec on its inter wire) from the same start."""
    t0 = time.perf_counter()
    world = HIER_SIGN[0] * HIER_SIGN[1]
    stats = spawn_shared("sharded_tinylm_hier_sign")
    wall = time.perf_counter() - t0
    root = stats[0]
    print(f"sharded: sharded_tinylm_hier_sign {describe('pd_sgdm_tinylm_hier')}"
          f", hierarchical{HIER_SIGN} on {world} ranks (flat axis), sign "
          f"inter codec, p={P}, 3 rounds, {wall:.1f} s with the spawn")
    for s in stats:
        print(f"sharded: sharded_tinylm_hier_sign rank {s['rank']}: launches "
              f"{s['launches'][0]}, isend bytes {s['sent']}, all_reduce "
              f"bytes {s['reduced']}")
    print(f"sharded: sharded_tinylm_hier_sign levels {root['levels']}; "
          f"(max |Δparam|, elements past the bar: sign flips) against the "
          f"dense round, per round {root['round_gaps']}")
    m = HIER_SIGN[1]
    for s in stats:
        for lc in s["launches"]:
            want = {**{n: 0 for n in lc}, "momentum_update": P,
                    "sign_pack": 1, "sign_unpack": 1}
            if lc != want:
                raise AssertionError(f"sharded_tinylm_hier_sign: {lc}")
        leader = s["rank"] % m == 0
        site = s["levels"]["inter_site"] if leader else 0
        if (s["sent"] != [site] * 3
                or s["reduced"] != [s["levels"]["intra_result"]] * 3
                or s["levels"] != s["bytes_model"]
                or tuple(s["cycle"]) != (s["levels"]["inter"],)):
            raise AssertionError(f"sharded_tinylm_hier_sign: bytes {s}")
    if root.get("round_missed"):
        raise AssertionError(f"sharded_tinylm_hier_sign: rounds "
                             f"{root['round_missed']} past the bar")


def resume_run(mesh_rank, runs):
    """``runs``: ``[(ckpt_dir, stop, resume)]`` of the tiny LM's PD-SGDM,
    kernel layout, p = 4, in these ranks; each run's final worker."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    path = "pd_sgdm_tinylm_hier"
    pack = build_train(lm_run(path, hyper=TINY_HYPER),
                       make_mesh((world,), ("w",), device=dev))
    stream = worker_stream(path, world)
    out = []
    for ckpt_dir, stop, resume in runs:
        res = ShardedTrainer(pack, ckpt_dir=ckpt_dir,
                             ckpt_every=stop if not resume else 0).train(
            0, lambda t: pack.worker_batch(stream(t)),
            RESUME_STEPS if resume or stop is None else stop, log_every=P,
            verbose=False, resume=resume)
        out.append(({n: v.cpu() for n, v in res["params"].items()},
                    {k: ({n: v.cpu() for n, v in s.items()}
                         if isinstance(s, dict) else s.cpu())
                     for k, s in res["state"].items()}, res["steps_run"]))
    return out


def elastic_rank(mesh_rank, ckpt_dir):
    """This rank's worker of the latest checkpoint in ``ckpt_dir``, restored
    into these K′ ranks."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer
    rank, world, dev = mesh_rank
    pack = build_train(lm_run("pd_sgdm_tinylm_hier", hyper=TINY_HYPER),
                       make_mesh((world,), ("w",), device=dev))
    params, state = ShardedTrainer(pack, ckpt_dir=ckpt_dir)._restore(
        latest_step(ckpt_dir))
    return ({n: v.cpu() for n, v in params.items()},
            {k: ({n: v.cpu() for n, v in s.items()}
                 if isinstance(s, dict) else s.cpu())
             for k, s in state.items()})


def sharded_resume_phase(torch):
    """``sharded_resume``: the tiny LM, K = 4, p = 4, kernel layout.  One set
    of ranks runs 12 steps unbroken and writes checkpoints at step 6 (off a
    round boundary) and step 8; a fresh set resumes each to step 12, bit for
    bit the unbroken run; 6 ranks restore the step-8 checkpoint: the
    survivors' slices bit for bit, the joiners their donors'."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="resume_") as d:
        dirs = {s: os.path.join(d, f"stop{s}") for s in RESUME_STOPS}
        first = spawn(resume_run, RESUME_K, [(None, None, False)] + [
            (dirs[s], s, False) for s in RESUME_STOPS])
        second = spawn(resume_run, RESUME_K, [
            (dirs[s], s, True) for s in RESUME_STOPS])
        grown = spawn(elastic_rank, RESUME_K2, dirs[8])
    wall = time.perf_counter() - t0

    def leaves(params, state):
        out = dict(params)
        for k, s in state.items():
            if isinstance(s, dict):
                out.update({f"{k}/{n}": v for n, v in s.items()})
            else:
                out[k] = s
        return out

    print(f"sharded: sharded_resume tiny LM, K={RESUME_K} ranks, p={P}, "
          f"kernel layout, {RESUME_STEPS} steps; checkpoints at "
          f"{RESUME_STOPS}, each resumed in fresh ranks; step 8 restored "
          f"into {RESUME_K2} ranks; {wall:.1f} s with the spawns")
    for rank in range(RESUME_K):
        base = leaves(*first[rank][0][:2])
        for i, stop in enumerate(RESUME_STOPS):
            got = leaves(*second[rank][i][:2])
            if second[rank][i][2] != RESUME_STEPS - stop or any(
                    not torch.equal(got[k], base[k]) for k in base):
                raise AssertionError(f"sharded_resume: rank {rank} resumed "
                                     f"from step {stop} differs")
    at8 = [leaves(*first[r][2][:2]) for r in range(RESUME_K)]
    for r in range(RESUME_K2):
        got = leaves(*grown[r])
        donor = at8[r % RESUME_K]
        if any(not torch.equal(got[k], donor[k]) for k in donor):
            raise AssertionError(f"sharded_resume: slot {r} of K'="
                                 f"{RESUME_K2} is not worker "
                                 f"{r % RESUME_K}'s")
    print(f"sharded: sharded_resume resumed from steps {RESUME_STOPS}: bit "
          f"for bit the unbroken run on every rank; K'={RESUME_K2}: slots "
          f"0-{RESUME_K - 1} their own, {RESUME_K}-{RESUME_K2 - 1} workers "
          f"0-{RESUME_K2 - RESUME_K - 1}'s, bit for bit")


# The codec paths of the sharded runtime: CPD-SGDM (and MT-DSGDm's
# compressed tracking) with their per-shift x̂ copies and codec payloads
# over P2P, in ranks spawned on this card as above.
CPD_OLMO_ROUNDS = 2
# x̂ elements a round that may be sign flips: one in a million (about
# 1,000 of OLMo-1B's one layer in four workers; PERF.md §6, PR 25)
CPD_OLMO_FLIP_SHARE = 1e-6
CHECKSUM_PRIME = 65_521
CHECKSUM_CHUNK = 1 << 24
# per round on every rank: p momentum launches, the consensus (one gossip
# launch over x̂ and the two copies), one pack and 1 + 2 unpacks (the own
# payload and each neighbour's)
CPD_ROUND_LAUNCHES = {"momentum_update": P, "gossip_mix": 1, "sign_pack": 1,
                      "sign_unpack": 3}
# OLMo-1B, one layer: 2 × 250,368 used rows × (128 + 4) B of sign payload
CPD_OLMO_BYTES = 66_097_152
# sharded_resnet_cpd's paths (K = 8 ranks, the ResNet path's settings), the
# kernels each launches in a 14-step run on every rank (3 rounds, each 1 +
# 2 unpacks; MT: the dense run's mixes and 2 more unpacks a round) and the
# dense path whose bytes it ships
CODEC_PATHS = {
    "cpd_sgdm_sign": {"momentum_update": STEPS, "gossip_mix": STEPS // P,
                      "sign_pack": STEPS // P, "sign_unpack": 3 * (STEPS // P)},
    "cpd_sgdm_qsgd": {"momentum_update": STEPS, "gossip_mix": STEPS // P,
                      "qsgd_quant": STEPS // P,
                      "qsgd_dequant": 3 * (STEPS // P)},
    "cpd_sgdm_topk": {"momentum_update": STEPS, "gossip_mix": STEPS // P,
                      "topk_select": STEPS // P,
                      "topk_scatter": 3 * (STEPS // P)},
    "mt_dsgdm_sign": {"momentum_update": STEPS, "gossip_mix": MT_MIXES,
                      "sign_pack": STEPS // P, "sign_unpack": 3 * (STEPS // P)},
    # under churn the comm runs on the tree at the round boundary: the
    # consensus is plain torch, the pruned payloads decode to 0 all the same
    "cpd_sgdm_sign_churn": {"momentum_update": STEPS, "sign_pack": STEPS // P,
                            "sign_unpack": 3 * (STEPS // P)},
}
EMB_PATH = "cpd_sgdm_sparse"
EMB_LAUNCHES = {"momentum_update": STEPS, "gossip_mix": STEPS // P,
                "row_gather": STEPS // P, "row_scatter": 3 * (STEPS // P)}
CODEC_FLIPS = 8             # churn: x̂ elements past the bar, a round


def nonzero(launches: dict) -> dict:
    return {n: v for n, v in launches.items() if v}


def stored_copy_comm(top, device):
    """A ``DenseComm`` whose ``mix`` is the sharded backend's consensus over
    its stored copies, ``w₀·x + Σ w·view`` in the shifts' order, on the
    stacked workers (plain PyTorch, ``kernels.ref.gossip_shift_ref``): the
    sharded round replayed on one device.  Static one-axis graphs."""
    from repro_torch.core import DenseComm
    from repro_torch.kernels.ref import gossip_shift_ref
    from repro_torch.tree import tree_map
    order = ([s for s in top.shifts if s[1] == 0]
             + [s for s in top.shifts if s[1] != 0])

    class StoredCopyComm(DenseComm):
        def mix(self, tree, r=None):
            return tree_map(lambda x: gossip_shift_ref(
                x.reshape(x.shape[0], 1, -1), [s for (_a, s, _w) in order],
                [w for (_a, _s, w) in order], grid=top.axis_sizes, axis=0,
                lim=1).reshape(x.shape), tree)

    return StoredCopyComm(top, device=device)


def bit_checksum(torch, tree) -> tuple:
    """Two checksums of a tree's f32 bits, leaves in name order: the sum of
    the int32 views, and the sum of each weighted by its element index mod
    65,521, both in int64 (wrapping mod 2⁶⁴), in chunks."""
    s0 = s1 = 0
    off = 0
    for name in sorted(tree):
        v = tree[name].detach().reshape(-1).view(torch.int32)
        for a in range(0, v.numel(), CHECKSUM_CHUNK):
            c = v[a:a + CHECKSUM_CHUNK].to(torch.int64)
            idx = torch.arange(off + a, off + a + c.numel(),
                               device=c.device) % CHECKSUM_PRIME
            s0 += int(c.sum())
            s1 += int((c * idx).sum())
        off += v.numel()
    return s0, s1


def replica_checksums(torch, state) -> dict:
    """This rank's checksums of x̂ and of each copy (``bit_checksum``)."""
    out = {"xhat": bit_checksum(torch, state["xhat"])}
    for key, copy in state["xhat_nbrs"].items():
        out[key] = bit_checksum(torch, copy)
    return out


def replica_misses(sums: list) -> list:
    """``(rank, key)`` of every copy whose checksums are not those of the
    x̂ of the rank it tracks (rank k's ``ax0_sh{s}`` tracks k + s mod K)."""
    k = len(sums)
    return [(r, key) for r, s in enumerate(sums) for key in s
            if key != "xhat"
            and s[key] != sums[(r + int(key[len("ax0_sh"):])) % k]["xhat"]]


def sharded_cpd_olmo_rank(mesh_rank):
    """A rank of ``sharded_olmo1b_cpd_sign``: CPD sign on OLMo-1B's widths,
    the kernel layout, two rounds through ``ShardedTrainer``; after each
    round the replica contract by checksums, compared on rank 0, and the
    round's result (the next one's start) held on the host; then every
    round of this rank's worker replayed from its start."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    path = "pd_sgdm_olmo1b"
    run = lm_run(path)
    run = dataclasses.replace(run, optim=dataclasses.replace(
        run.optim, name="cpd_sgdm", compressor="sign", gamma=GAMMA))
    pack = build_train(run, make_mesh((world,), ("w",), device=dev))
    stream = worker_stream(path, world)
    rounds, sums, held = [], [], []
    watch_rounds(torch, pack, rounds, keep=False)
    timed = pack.train_round

    def train_round(params, state, batches, t):
        out = timed(params, state, batches, t)
        got = [None] * world
        dist.all_gather_object(got, replica_checksums(torch, out[1]))
        sums.append(got)
        # the round's x and x̂ on the host, and where a round follows the
        # rest of its start: m and the copies
        keep = {"x": out[0], "xhat": out[1]["xhat"]}
        if len(held) + 1 < CPD_OLMO_ROUNDS:
            keep.update(out[1]["xhat_nbrs"], m=out[1]["m"])
        plan = kops.KernelPlan.for_tree(out[0], worker_dim=True)
        held.append({k: plan.flatten(v).cpu() for k, v in keep.items()})
        return out
    pack.train_round = train_round
    trainer = ShardedTrainer(pack)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    out = trainer.train(0, lambda t: pack.worker_batch(stream(t)),
                        CPD_OLMO_ROUNDS * P, log_every=P, verbose=False)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    plan = kops.KernelPlan.for_tree(out["params"], worker_dim=True)
    stats = {"rank": rank, "peak_mib": peak / 2 ** 20,
             "s_per_round": [r["s"] for r in rounds],
             "launches": [r["launches"] for r in rounds],
             "sent": [r["sent"] for r in rounds],
             "cycle": trainer.bytes_per_round_cycle(),
             "used": plan.used_rows, "losses": out["history"].loss,
             "replica_misses": [replica_misses(s) for s in sums]}
    del rounds[:], out, pack, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    stats["rounds"] = replay_cpd_olmo_rounds(torch, path, stream, mesh_rank,
                                             held)
    return stats


def replay_cpd_olmo_rounds(torch, path, stream, mesh_rank, held) -> list:
    """Each round of this rank's worker of ``sharded_olmo1b_cpd_sign``
    replayed from its start (x0 for round 0, then the round before's
    result in ``held``): the dense backend's local steps of the one worker
    (the rank's gradient: plain autograd under the run's ``remat``; the
    momentum kernel on the same grads), then the sharded formula with
    the plain versions: the consensus over x̂ and the two copies (each the
    x̂ of the worker it tracks, by the checksums), x + γ(mix − x̂), the sign
    codec of the drift, x̂ + q.  Held against the round's result in
    ``held``: the params within the kernel-round bar, x̂ within it but for
    sign flips, each an element whose replayed drift lies within the two
    sides' gap in x (plus 4 ulps) of zero and whose decoded sign differs.
    One report a round: the max |Δparam|, the flips, how far they moved
    x̂, anything else past the bar, the elements."""
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (gossip_mix_ref, sign_pack_rows_ref,
                                         sign_unpack_ref)
    from repro_torch.launch.runtime import worker_grad_fn
    from repro_torch.train.trainer import _stack_batches
    rank, world, dev = mesh_rank
    # the rank's own gradient: plain autograd, the run's remat
    grads_fn = worker_grad_fn(lm_model(path), lm_run(path).parallel.remat)
    x0 = lm_model(path).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    one = {n: v.unsqueeze(0) for n, v in x0.items()}
    del x0
    plan = kops.KernelPlan.for_tree(one, worker_dim=True)
    dopt = make_optimizer("pd_sgdm", DenseComm(ring(1), device=dev),
                          use_kernel=True, **FULL_HYPER)
    top = ring(world)
    nbrs = [(f"ax0_sh{sh:+d}", w) for (_a, sh, w) in top.shifts if sh != 0]
    weights = ([sum(w for (_a, sh, w) in top.shifts if sh == 0)]
               + [w for (_k, w) in nbrs])
    counts = plan.row_counts(dev).reshape(-1, 1)
    ulp = 4 * torch.finfo(torch.float32).eps
    elements = sum(v.numel() for v in one.values())
    reports, start = [], None
    for rnd, end in enumerate(held):
        t = rnd * P
        if start is None:
            params = one
            state = dopt.init(params)
            xh = plan.flatten(one)
            views = [xh] * len(weights)
        else:
            params = plan.unflatten(start.pop("x").to(dev),
                                    dtype=torch.float32)
            state = dopt.init(params)
            state["m"] = plan.unflatten(start.pop("m").to(dev),
                                        dtype=torch.float32)
            state["step"].fill_(t)
            xh = start.pop("xhat").to(dev)
            views = [xh] + [start.pop(k).to(dev) for (k, _w) in nbrs]
        batches = _stack_batches([{k: v[rank:rank + 1] for k, v in
                                   stream(t + i).items()} for i in range(P)])
        params, state, _ = dopt.round(state, params, grads_fn, batches,
                                      gossip=False)
        x_loc = plan.flatten(params)
        del params, state
        mix = gossip_mix_ref(views, weights)
        del views
        x_new = (x_loc + GAMMA * (mix - xh))[0]
        del mix, x_loc
        gx = end["x"].to(dev)[0]
        others = [] if torch.allclose(gx, x_new, **ROUND_BAR) else ["params"]
        diff = x_new - xh[0]
        near = diff.abs() <= ((gx - x_new).abs()
                              + ulp * torch.maximum(x_new.abs(),
                                                    xh[0].abs()))
        gap = float((x_new - gx).abs().max())
        del x_new, gx
        packed, scales = sign_pack_rows_ref(diff, counts)
        q = sign_unpack_ref(packed, scales)
        del diff, packed, scales
        xh_new = xh[0] + q
        got = end["xhat"].to(dev)[0]
        far = ~torch.isclose(got, xh_new, **ROUND_BAR)
        # a flip: the drift within rounding of zero, its sign the other
        # way on the two sides, so x̂ moves by ±scale the other way
        flip = far & near & ((got - xh[0] > 0) != (q > 0))
        moved = (float((got - xh_new).abs()[flip].max())
                 if bool(flip.any()) else 0.0)
        if bool((far & ~flip).any()):
            others.append((int((far & ~flip).sum()),
                           float((got - xh_new).abs()[far & ~flip].max())))
        reports.append({"gap": gap, "flips": int(flip.sum()),
                        "moved": moved, "others": others,
                        "elements": elements})
        del xh, q, xh_new, got, far, flip, near
        start = end
    return reports


def sharded_cpd_olmo_phase(torch, pd_stats):
    """``sharded_olmo1b_cpd_sign``: CPD-SGDM with the sign codec at OLMo-1B's
    published widths (one of 16 layers, f32), ``sharded_olmo1b``'s cuts and
    step, γ = 0.4, K = 4 ranks on a ring, the kernel layout, two rounds
    through ``ShardedTrainer``: per round on every rank 4 momentum, 1
    gossip, 1 ``sign_pack`` and 3 ``sign_unpack`` launches and 66,097,152
    B handed to ``isend`` (``bytes_per_round_cycle``); after each round
    every copy's bit checksums equal those of the x̂ it tracks; every
    round of every worker, from its start, within the kernel-round bar of
    the sharded formula replayed with the plain versions, x̂ but for its
    sign flips, at most ``CPD_OLMO_FLIP_SHARE`` of the elements a round
    (``replay_cpd_olmo_rounds``); each rank's peak and s/round beside
    ``sharded_olmo1b``'s from the same call."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats = spawn_shared("sharded_olmo1b_cpd_sign")
    wall = time.perf_counter() - t0
    root = stats[0]
    name = "sharded_olmo1b_cpd_sign"
    print(f"sharded: {name} CPD-SGDM sign (γ={GAMMA}) on "
          f"{describe('pd_sgdm_olmo1b')}, K={SHARDED_OLMO_K} ranks on one card"
          f" (gloo), ring, p={P}, {CPD_OLMO_ROUNDS} rounds through "
          f"ShardedTrainer, {wall:.1f} s with the spawn and the checks")
    print(f"sharded: {name} losses (the ranks' mean) "
          + " ".join(f"{v:.4f}" for v in root["losses"]))
    pd_stats = pd_stats or [{"peak_mib": float("nan"),
                             "s_per_round": []}] * len(stats)
    for s, pd in zip(stats, pd_stats):
        print(f"sharded: {name} rank {s['rank']}: peak {s['peak_mib']:.1f} "
              f"MiB (PD's {pd['peak_mib']:.1f}), s/round (gloo's host-staged"
              " wire) " + ", ".join(f"{v:.4f}" for v in s["s_per_round"])
              + " (PD's " + ", ".join(f"{v:.4f}" for v in pd["s_per_round"])
              + f"), launches {[nonzero(lc) for lc in s['launches']]}, "
              f"isend bytes {s['sent']}")
    print(f"sharded: {name} peak summed over the ranks "
          f"{sum(s['peak_mib'] for s in stats):.1f} MiB (PD's "
          f"{sum(s['peak_mib'] for s in pd_stats):.1f}); replica contract "
          f"(bit checksums of every copy against the x̂ it tracks) misses "
          f"per round {root['replica_misses']}")
    missed = []
    for i in range(CPD_OLMO_ROUNDS):
        rds = [s["rounds"][i] for s in stats]
        flips = sum(rd["flips"] for rd in rds)
        bound = int(CPD_OLMO_FLIP_SHARE * sum(rd["elements"] for rd in rds))
        others = [(s["rank"], s["rounds"][i]["others"]) for s in stats
                  if s["rounds"][i]["others"]]
        print(f"sharded: {name} round {i} from its start against the "
              f"replayed sharded formula: max |Δparam| per worker "
              f"{[rd['gap'] for rd in rds]}, x̂ sign flips {flips} of at "
              f"most {bound} (each moved by at most "
              f"{max(rd['moved'] for rd in rds):.3g}), elements past the "
              f"bar otherwise {others}")
        if others or flips > bound:
            missed.append((i, flips, bound, others))
    for s in stats:
        for lc in s["launches"]:
            if lc != {**{n: 0 for n in lc}, **CPD_ROUND_LAUNCHES}:
                raise AssertionError(f"{name}: launches {lc}")
        if (tuple(s["cycle"]) != (CPD_OLMO_BYTES,)
                or s["sent"] != [CPD_OLMO_BYTES] * CPD_OLMO_ROUNDS):
            raise AssertionError(f"{name}: isend bytes {s['sent']}, cycle "
                                 f"{s['cycle']}, expected {CPD_OLMO_BYTES}")
    if any(root["replica_misses"]) or len(root["replica_misses"]) != \
            CPD_OLMO_ROUNDS:
        raise AssertionError(f"{name}: replica contract {root['replica_misses']}")
    if missed or not all(math.isfinite(v) for v in root["losses"]):
        raise AssertionError(f"{name}: rounds against the replay {missed}, "
                             f"losses {root['losses']}")


def codec_rank_opt(path, mesh):
    """A ``sharded_resnet_cpd`` path's optimizer on the ranks' ring, built
    as ``make_opt`` builds the dense path's (the churn path under its
    membership script)."""
    from repro_torch.core import (QSGDCompressor, ShardedComm, SignCompressor,
                                  TopKCompressor, make_optimizer,
                                  membership_from_events, ring)
    membership = (membership_from_events(K, CHURN_ROUNDS, CHURN_EVENTS)
                  if path.endswith("_churn") else None)
    comm = ShardedComm(ring(mesh.world_size), axis_names=("w",), mesh=mesh,
                       membership=membership)
    if path == "mt_dsgdm_sign":
        return make_optimizer("mt_dsgdm", comm, use_kernel=True,
                              compressor=SignCompressor(),
                              **dict(HYPER, eta=TRACK_ETA))
    comp, gamma = {
        "cpd_sgdm_qsgd": (QSGDCompressor(levels=QSGD_LEVELS), GAMMA),
        "cpd_sgdm_topk": (TopKCompressor(fraction=TOPK_FRACTION),
                          TOPK_GAMMA)}.get(path, (SignCompressor(), GAMMA))
    return make_optimizer("cpd_sgdm", comm, gamma=gamma, compressor=comp,
                          use_kernel=True, **HYPER)


def rank_pack(torch, opt, mesh, init_fn, grads_fn, struct):
    """A ``TrainPack`` of this rank's worker for a model without a
    ``ModelCfg`` (ResNet-20, the embedding table)."""
    from repro_torch.configs.base import ParallelCfg
    from repro_torch.launch.mesh import make_layout
    from repro_torch.launch.runtime import (TrainPack, check_state_keys,
                                            make_steps)
    train_step, train_round = make_steps(opt, grads_fn)
    return TrainPack(model=None, opt=opt,
                     layout=make_layout(ParallelCfg(), mesh),
                     device=mesh.device, params_struct=struct,
                     state_struct=opt.init(struct),
                     state_keys=check_state_keys(opt.init(struct)),
                     init_fn=init_fn, train_step=train_step,
                     train_round=train_round)


def codec_run(torch, pack, steps, stream, seed: int):
    """``steps`` steps of a codec path through ``ShardedTrainer`` in this
    rank: per round its launches, isend bytes, start (params, m and the
    coded state: CPD's x̂, MT's tracking pair, on the host) and the replica
    contract by the copies gathered to rank 0 (bit for bit); the end of
    the last round and the final worker."""
    import torch.distributed as dist
    from repro_torch.train.trainer import ShardedTrainer
    keys = ("m",) + (("c", "g_prev") if "c" in pack.state_struct
                     else ("xhat",))
    rounds, misses = [], []
    watch_rounds(torch, pack, rounds, keep=False)
    timed = pack.train_round

    def host(params, state):
        return ({n: v.detach().cpu().clone() for n, v in params.items()},
                {k: {n: v.detach().cpu().clone() for n, v in state[k].items()}
                 for k in keys})

    def train_round(params, state, batches, t):
        start = host(params, state)
        out = timed(params, state, batches, t)
        rounds[-1]["start"], rounds[-1]["end"] = start, host(*out[:2])
        if "xhat_nbrs" in out[1]:
            mine = dict(out[1]["xhat_nbrs"], xhat=out[1]["xhat"])
            mine = {k: {n: v.detach().cpu() for n, v in tree.items()}
                    for k, tree in mine.items()}
            root = dist.get_rank() == 0
            got = [None] * dist.get_world_size() if root else None
            dist.gather_object(mine, got, dst=0)
            if root:
                k = len(got)
                misses.append([
                    (r, key) for r, g in enumerate(got) for key in g
                    if key != "xhat" and any(
                        not torch.equal(g[key][n], got[
                            (r + int(key[len("ax0_sh"):])) % k]["xhat"][n])
                        for n in g[key])])
        return out
    pack.train_round = train_round
    kernels = reset_counters()
    out = ShardedTrainer(pack).train(seed, lambda t: pack.worker_batch(
        stream(t)), steps, log_every=1, verbose=False)
    sync(torch, pack.device)
    return {"launches": {n: f.launches for n, f in kernels.items()},
            "sent": [r["sent"] for r in rounds],
            "cycle": ShardedTrainer(pack).bytes_per_round_cycle(),
            "rounds": [(r["start"], r["t"]) for r in rounds],
            "last_end": rounds[-1]["end"],
            "final": host(out["params"], out["state"]),
            "losses": out["history"].loss, "replica_misses": misses}


def sharded_codec_rank(mesh_rank, paths, seed: int):
    """A rank of ``sharded_resnet_cpd``: each path's ResNet-20 worker
    through a ``TrainPack`` of its own and ``ShardedTrainer``, 14 steps."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.resnet import resnet20_init
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh((world,), ("w",), device=dev)
    struct = {n: torch.empty((1,) + tuple(v.shape[1:]), device="meta")
              for n, v in stacked_init(torch, seed, 1).items()}
    out = {}
    for path in paths:
        opt = codec_rank_opt(path, mesh)

        def init_fn(s, opt=opt):
            gen = torch.Generator(device=dev).manual_seed(s)
            params = {n: v.unsqueeze(0) for n, v in
                      resnet20_init(gen, width=WIDTH, device=dev).items()}
            return params, opt.init(params)
        pack = rank_pack(torch, opt, mesh, init_fn,
                         resnet_grads_fn(torch), struct)
        out[path] = codec_run(torch, pack, STEPS, batch_fn(seed, world),
                              seed)
    return out


def replay_codec_rounds(torch, name, res, dopt, grads_fn, stream, steps,
                        bitwise: bool):
    """Each round of a sharded codec run (``res``: the ranks' results of
    one path) and its tail, from the stacked start, against ``dopt``'s
    dense round from that start on the same batches: bit for bit (params
    and the coded state), or (``bitwise=False``) params within the
    kernel-round bar and the coded state within it but for at most
    ``CODEC_FLIPS`` elements a round; returns the gaps and the flips."""
    from repro_torch.train.trainer import _stack_batches

    def cat(trees):
        return {n: torch.cat([t[n] for t in trees]).to(DEVICE)
                for n in trees[0]}

    n_rounds = len(res[0]["rounds"])
    report = []
    for i in range(n_rounds + 1):
        if i < n_rounds:
            t = res[0]["rounds"][i][1]
            start = [r["rounds"][i][0] for r in res]
            end = [r["rounds"][i + 1][0] if i + 1 < n_rounds
                   else r["last_end"] for r in res]
            n = P
        else:                               # the tail: local steps only
            t = n_rounds * P
            start = [r["last_end"] for r in res]
            end = [r["final"] for r in res]
            n = steps - t
        params = cat([s[0] for s in start])
        state = {k: cat([s[1][k] for s in start]) for k in start[0][1]}
        state["step"] = torch.tensor(t, dtype=torch.int32, device=DEVICE)
        batches = _stack_batches([stream(t + j) for j in range(n)])
        got_p, got_s, _ = dopt.round(state, params, grads_fn, batches,
                                     gossip=n == P)
        want_p = cat([e[0] for e in end])
        want_s = {k: cat([e[1][k] for e in end]) for k in end[0][1]}
        gap = max(float((got_p[n_] - want_p[n_]).abs().max())
                  for n_ in want_p)
        flips = 0
        for k in want_s:
            for n_ in want_s[k]:
                a, b = got_s[k][n_], want_s[k][n_]
                if bitwise:
                    flips += int((a != b).sum())
                else:
                    flips += int((~torch.isclose(a, b, **ROUND_BAR)).sum())
        if bitwise:
            ok = flips == 0 and all(torch.equal(got_p[n_], want_p[n_])
                                    for n_ in want_p)
        else:
            ok = (flips <= CODEC_FLIPS and all(
                torch.allclose(want_p[n_], got_p[n_], **ROUND_BAR)
                for n_ in want_p))
        if not ok:
            raise AssertionError(f"{name}: round {i} "
                                 f"differs from the replayed round: "
                                 f"|Δparam| {gap}, state elements {flips}")
        report.append((gap, flips))
    return report


def sharded_resnet_cpd_phase(torch):
    """``sharded_resnet_cpd``: the paper's Algorithm 2 on its own model,
    ResNet-20 width 16, batch 16, K = 8 ranks on the ring, p = 4, η = 0.1,
    14 steps (3 rounds, a 2-step tail), cuDNN deterministic, in one spawn:
    CPD sign, CPD QSGD (4-bit), CPD top-10 % (γ = 0.2), MT sign (η = 0.05)
    and CPD sign under ``CHURN_EVENTS``.  On every rank the launches of
    ``CODEC_PATHS`` and the bytes of the dense path's ``WIRE_BYTES`` (under
    churn their mean over the ranks, the commit-weighted figure); the
    replica contract bit for bit after every round, the churn rounds too;
    each round and the tail bit for bit the sharded formula replayed on
    the stacked workers with their gradients taken worker by worker (the
    port's dense kernel round with the stored-copy consensus; MT's dense
    round is that formula), the churn path's within the kernel-round bar
    of the dense round (``W_r @ x̂``) but for its sign flips."""
    from repro_torch.core import ring
    t0 = time.perf_counter()
    stats = spawn_shared("sharded_resnet_cpd")
    wall = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = True
    stream = batch_fn(0, K)
    grads_fn = resnet_grads_fn(torch, per_worker=True)
    print(f"sharded: sharded_resnet_cpd ResNet-20 width {WIDTH}, batch "
          f"{BATCH}, K={K} ranks on one card (gloo), ring, {STEPS} steps "
          f"through ShardedTrainer, five paths in one spawn, {wall:.1f} s")
    for path, want in CODEC_PATHS.items():
        res = [s[path] for s in stats]
        dopt = make_opt(path, True)
        if path.startswith("cpd") and not path.endswith("_churn"):
            dopt.comm = stored_copy_comm(ring(K), DEVICE)
        report = replay_codec_rounds(torch, path, res, dopt, grads_fn,
                                     stream, STEPS,
                                     bitwise=not path.endswith("_churn"))
        launches = {n: want.get(n, 0) for n in counters()}
        wire = WIRE_BYTES[path]
        rounds = STEPS // P
        want_sent = sum(wire[r % len(wire)] for r in range(rounds))
        sent = [sum(r["sent"]) for r in res]
        print(f"sharded: sharded_resnet_cpd {path}: launches per rank "
              f"{nonzero(res[0]['launches'])}, isend bytes per rank {sent} "
              f"(cycle "
              f"{res[0]['cycle']}), replica misses per round "
              f"{res[0]['replica_misses']}, (max |Δparam|, state elements "
              f"apart) against the replayed round, per round and the tail "
              f"{report}; losses "
              + " ".join(f"{v:.4f}" for v in res[0]["losses"]))
        for r in res:
            if r["launches"] != launches:
                raise AssertionError(f"sharded_resnet_cpd: {path} launches "
                                     f"{r['launches']}, expected {launches}")
            if tuple(r["cycle"]) != wire:
                raise AssertionError(f"sharded_resnet_cpd: {path} cycle "
                                     f"{r['cycle']}, expected {wire}")
        if path.endswith("_churn"):
            if abs(sum(sent) / len(sent) - want_sent) > 1e-6:
                raise AssertionError(f"sharded_resnet_cpd: {path} mean bytes"
                                     f" {sum(sent) / len(sent)}, expected "
                                     f"{want_sent}")
        elif sent != [want_sent] * K:
            raise AssertionError(f"sharded_resnet_cpd: {path} bytes {sent}")
        misses = res[0]["replica_misses"]
        if path.startswith("cpd") and (len(misses) != rounds or any(misses)):
            raise AssertionError(f"sharded_resnet_cpd: {path} replica "
                                 f"contract {misses}")
        if not all(math.isfinite(v) for v in res[0]["losses"]):
            raise AssertionError(f"sharded_resnet_cpd: {path} losses")
    torch.backends.cudnn.deterministic = False


def sharded_embedding_rank(mesh_rank, seed: int):
    """A rank of ``sharded_embedding_cpd_sparse``: its worker of the
    (4, 65536, 64) table, CPD with the sparse-rows codec, 14 steps."""
    import torch
    from repro_torch.core import (CPDSGDM, CPDSGDMConfig, ShardedComm,
                                  SparseRowsCompressor, ring)
    from repro_torch.data.synthetic import EmbedStreamCfg, embed_batch
    from repro_torch.launch.mesh import make_mesh
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    mesh = make_mesh((world,), ("w",), device=dev)
    opt = CPDSGDM(CPDSGDMConfig(use_kernel=True, **EMB_HYPER),
                  ShardedComm(ring(world), axis_names=("w",), mesh=mesh),
                  SparseRowsCompressor(max_rows=EMB_MAX_ROWS))

    def init_fn(s):
        # one table for every worker (the sharded runtime's x0): CPD's init
        # seeds each copy of a neighbour's x̂ with the rank's own x0, as the
        # reference's does, so the copies track their owners only from a
        # common start (the dense path draws a table per worker)
        gen = torch.Generator(device=dev).manual_seed(s)
        params = {"table": torch.randn((1, EMB_ROWS, EMB_DIM), generator=gen,
                                       device=dev) * 0.1}
        return params, opt.init(params)
    struct = {"table": torch.empty((1, EMB_ROWS, EMB_DIM), device="meta")}
    pack = rank_pack(torch, opt, mesh, init_fn, embedding_grads(torch),
                     struct)
    cfg = EmbedStreamCfg(n_rows=EMB_ROWS, dim=EMB_DIM, batch=EMB_BATCH,
                         n_workers=EMB_K, seed=seed)
    return codec_run(torch, pack, STEPS, lambda t: embed_batch(cfg, t, dev),
                     seed)


def sharded_embedding_phase(torch):
    """``sharded_embedding_cpd_sparse``: ``cpd_sgdm_sparse``'s table in K = 4
    ranks on the ring, 14 steps through ``ShardedTrainer``: on every rank
    ``EMB_LAUNCHES`` (the row gather and scatter on the sharded path) and
    3 × 524,800 B to ``isend``; the replica contract bit for bit after
    every round; each round and the tail bit for bit the sharded formula
    replayed on the stacked tables."""
    from repro_torch.core import ring
    from repro_torch.data.synthetic import EmbedStreamCfg, embed_batch
    t0 = time.perf_counter()
    res = spawn_shared("sharded_embedding_cpd_sparse")
    wall = time.perf_counter() - t0
    dopt = make_opt(EMB_PATH, True)
    dopt.comm = stored_copy_comm(ring(EMB_K), DEVICE)
    cfg = EmbedStreamCfg(n_rows=EMB_ROWS, dim=EMB_DIM, batch=EMB_BATCH,
                         n_workers=EMB_K, seed=0)
    report = replay_codec_rounds(
        torch, EMB_PATH, res, dopt, embedding_grads(torch),
        lambda t: embed_batch(cfg, t, DEVICE), STEPS, bitwise=True)
    launches = {n: EMB_LAUNCHES.get(n, 0) for n in counters()}
    wire = WIRE_BYTES[EMB_PATH]
    sent = [sum(r["sent"]) for r in res]
    print(f"sharded: sharded_embedding_cpd_sparse ({EMB_K}, {EMB_ROWS}, "
          f"{EMB_DIM}) table, K={EMB_K} ranks (gloo), ring, sparse rows "
          f"(max_rows {EMB_MAX_ROWS}), {STEPS} steps, {wall:.1f} s with the "
          f"spawn: launches per rank {nonzero(res[0]['launches'])}, isend "
          f"bytes per "
          f"rank {sent}, replica misses per round "
          f"{res[0]['replica_misses']}, (max |Δparam|, elements apart) "
          f"against the replayed round {report}")
    for r in res:
        if r["launches"] != launches or tuple(r["cycle"]) != wire:
            raise AssertionError(f"sharded_embedding_cpd_sparse: launches "
                                 f"{r['launches']}, cycle {r['cycle']}")
    if sent != [wire[0] * (STEPS // P)] * EMB_K:
        raise AssertionError(f"sharded_embedding_cpd_sparse: bytes {sent}")
    misses = res[0]["replica_misses"]
    if len(misses) != STEPS // P or any(misses):
        raise AssertionError(f"sharded_embedding_cpd_sparse: replica "
                             f"contract {misses}")


# Tensor parallelism inside a worker: PD-SGDM on OLMo-1B's published widths
# over a 2 × 2 mesh (K = 2 workers × a model axis of 2, 4 gloo ranks on the
# card), each rank its shards of the worker (launch/sharding.py), and the
# port's pretraining example on the reference's own mesh (4 workers × 2).
# one round each: the script's time budget went to the split-worker
# phases (a second round, 2.3-2.9 s, measured the steady round)
TP_K, TP_AXIS, TP_ROUNDS = 2, 2, 1
# OLMo-1B at 2 of its 16 layers (one would leave the recomputation little
# to save), f32, seq 2,048 (its published context), batch 1 a worker
TP_OLMO = dict(arch="olmo-1b", cuts=dict(n_layers=2), seq=2048, batch=1)
# ROADMAP C.6: the bar of a round against the same round elsewhere
TP_BAR = 4.8e-7
# a rank's plan: half of each leaf, whole 1,024-lane rows (the embedding's
# and the head's 25,152 × 2,048, and per layer 4 × 4,096 + 2 × 16,384 rows
# of the attention and the MLP): 149,760 rows, handed once a round to the
# one neighbour of ring(2); a worker's two ranks, 1,226,833,920 B, are the
# reference's one-plan figure (no leaf is replicated under the
# non-parametric LayerNorm, and no shard has a tail row)
TP_RANK_ROWS = 149_760
TP_RANK_BYTES = TP_RANK_ROWS * 1024 * 4
TP_LAUNCHES = {"momentum_update": P, "gossip_mix": 1}
SWEEP_STEPS = 8
# the sweep's training rows (benchmarks/pretrain_sweep.py:20-31): the flat
# ring, and hierarchical(2, 2) with the bf16 inter wire, on 4 workers
SWEEP_RUNS = {"flat": [], "hier": ["--node-size", "2", "--wire-dtype",
                                   "bfloat16"]}


def tp_run(remat: str):
    """The RunCfg of ``sharded_olmo1b_tp2``: OLMo-1B at ``TP_OLMO``'s cuts,
    PD-SGDM at the full-width step on the kernel layout."""
    from repro_torch.configs.base import OptimCfg, ParallelCfg, RunCfg
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(TP_OLMO["arch"]).model,
                              param_dtype="float32", compute_dtype="float32",
                              **TP_OLMO["cuts"])
    return RunCfg(model=cfg,
                  parallel=ParallelCfg(profile="A", remat=remat,
                                       topology="ring"),
                  optim=OptimCfg(name="pd_sgdm", use_kernel=True,
                                 **FULL_HYPER))


def tp_stream():
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    cfg = LMStreamCfg(vocab=tp_run("none").model.vocab,
                      seq_len=TP_OLMO["seq"], batch=TP_OLMO["batch"],
                      n_workers=TP_K, seed=0)
    return lambda t: lm_batch(cfg, t, DEVICE)


def per_worker_grads_fn(torch, model, remat: str = "none"):
    """The K stacked workers' gradients worker by worker, each in plain
    autograd (``worker_grad_fn``): a model axis of 1, as a sharded rank
    takes its gradient, on the dense backend."""
    from repro_torch.launch.runtime import worker_grad_fn
    one = worker_grad_fn(model, remat)

    def grads_fn(params, batch):
        k = next(iter(params.values())).shape[0]
        outs = [one({n: v[w:w + 1] for n, v in params.items()},
                    {n: v[w:w + 1] for n, v in batch.items()})
                for w in range(k)]
        return (torch.stack([o[0] for o in outs]).mean(),
                {n: torch.cat([o[1][n] for o in outs]) for n in params})
    return grads_fn


def tp_rank_gradient_peak(torch, pack, remat, params, batch, dev) -> float:
    """One step's gradient of this rank above its params (MiB): the peak
    of its plain-autograd gradient, the grads it returns included."""
    from repro_torch.launch.runtime import worker_grad_fn
    gc.collect()
    torch.cuda.empty_cache()
    sync(torch, dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _, grads = worker_grad_fn(pack.model, remat)(params, batch)
    sync(torch, dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    del grads
    return peak / 2 ** 20


def tp_olmo_rank(mesh_rank):
    """A rank of ``sharded_olmo1b_tp2``: ``TP_ROUNDS`` rounds through
    ``ShardedTrainer`` with ``remat="full"``, then as many with
    ``"none"`` (each rank its shards of one worker); per round its
    launches, bytes and wall, the two settings' results compared on the
    rank, each setting's peaks; then (rank 0) each "full" round from its
    start, gathered whole, against the same round with a model axis of 1
    (``DenseComm(ring(2))``, gradients worker by worker)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer, gather_workers
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    on_card = dev.type == "cuda"
    mesh = make_mesh((TP_K,), ("data",), device=dev, model_axis=TP_AXIS)
    stream = tp_stream()
    stats = {"rank": rank}
    ends, held = {}, []
    for remat in ("full", "none"):
        pack = build_train(tp_run(remat), mesh)
        rounds = []
        watch_rounds(torch, pack, rounds)
        trainer = ShardedTrainer(pack)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        out = trainer.train(0, lambda t: pack.worker_batch(stream(t)),
                            TP_ROUNDS * P, log_every=P, verbose=False)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        plan = kops.KernelPlan.for_tree(out["params"], worker_dim=True)
        ends[remat] = [plan.flatten(r["end"]).cpu() for r in rounds]
        if remat == "full":
            held = [(r["start"][0], r["start"][1]["m"], r["end"], r["t"])
                    for r in rounds]
        stats[remat] = {
            "peak_mib": peak / 2 ** 20,
            "s_per_round": [r["s"] for r in rounds],
            "launches": [r["launches"] for r in rounds],
            "sent": [r["sent"] for r in rounds],
            "rank_cycle": trainer.rank_bytes_per_round_cycle(),
            "worker_cycle": trainer.bytes_per_round_cycle(),
            "used": plan.used_rows, "losses": out["history"].loss}
        del rounds, out, plan
        if on_card:
            stats[remat]["gradient_peak_mib"] = tp_rank_gradient_peak(
                torch, pack, remat, pack.init_fn(0)[0],
                pack.worker_batch(stream(0)), dev)
        stats[remat]["copy_mib"] = sum(
            v.numel() * 4 for v in pack.params_struct.values()) / 2 ** 20
        if remat == "full":
            # the rounds' starts and ends, whole, on rank 0's host
            layout, tplan = pack.layout, pack.plan
            held = [(gather_workers(x, True, layout, tplan),
                     gather_workers(m, True, layout, tplan),
                     gather_workers(e, True, layout, tplan), t)
                    for (x, m, e, t) in held]
        del pack, trainer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    stats["remat_gaps"] = [float((a - b).abs().max()) for a, b in
                           zip(ends["full"], ends["none"])]
    stats["remat_bitwise"] = all(torch.equal(a, b) for a, b in
                                 zip(ends["full"], ends["none"]))
    del ends
    if rank != 0:
        dist.barrier()
        return stats
    # each round against the same round at a model axis of 1
    model = tp_run("none")
    from repro_torch.models import make_model
    grads_fn = per_worker_grads_fn(torch, make_model(model.model))
    dopt = make_optimizer("pd_sgdm", DenseComm(ring(TP_K), device=dev),
                          use_kernel=True, **FULL_HYPER)
    from repro_torch.train.trainer import _stack_batches
    gaps = []
    for (x, m, want, t) in held:
        params = {n: v.to(dev) for n, v in x.items()}
        state = dopt.init(params)
        state["m"] = {n: v.to(dev) for n, v in m.items()}
        state["step"].fill_(t)
        batches = _stack_batches([stream(t + i) for i in range(P)])
        params, state, _ = dopt.round(state, params, grads_fn, batches)
        gaps.append(max(float((params[n] - want[n].to(dev)).abs().max())
                        for n in params))
        del params, state
    stats["round_gaps"] = gaps
    dist.barrier()
    return stats


def tp_dp_rank(mesh_rank):
    """A rank of ``sharded_olmo1b_tp2``: ``tp_olmo_rank``, then the same
    ranks under ``inner="dp"`` (``split_rank``)."""
    return {"tp": tp_olmo_rank(mesh_rank),
            "dp": split_rank(mesh_rank, ["sharded_olmo1b_dp2"])}


def sharded_tp_phase(torch):
    """``sharded_olmo1b_tp2``: PD-SGDM at OLMo-1B's published widths (2 of
    16 layers, f32, seq 2,048, batch 1) on K = 2 workers × a model axis of
    2, 4 ranks on the card, the kernel layout: ``TP_ROUNDS`` rounds with
    ``remat="full"`` and as many with ``"none"``; per rank and round
    p momentum and 1 gossip launches on its own shards and
    ``TP_RANK_BYTES`` to ``isend``; each round within ``TP_BAR`` of the
    same round with a model axis of 1 from the same start; "full" against
    "none"; each rank's allocator and gradient peaks and s/round for
    both."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    both = spawn_shared("sharded_olmo1b_tp2")
    wall = time.perf_counter() - t0
    stats = [s["tp"] for s in both]
    root = stats[0]
    name = "sharded_olmo1b_tp2"
    print(f"sharded: {name} PD-SGDM on OLMo-1B's widths, "
          f"{TP_OLMO['cuts']['n_layers']} of 16 layers, f32, seq "
          f"{TP_OLMO['seq']}, batch {TP_OLMO['batch']}, K={TP_K} workers × "
          f"model axis {TP_AXIS} ({TP_K * TP_AXIS} ranks on one card, gloo),"
          f" ring, p={P}, {TP_ROUNDS} round(s) with remat='full' and "
          f"{TP_ROUNDS} with 'none' through ShardedTrainer, {wall:.1f} s "
          "with the spawn and the checks")
    for remat in ("full", "none"):
        print(f"sharded: {name} remat={remat} losses (the workers' mean) "
              + " ".join(f"{v:.4f}" for v in root[remat]["losses"]))
        for s in stats:
            r = s[remat]
            print(f"sharded: {name} remat={remat} rank {s['rank']}: peak "
                  f"{r['peak_mib']:.1f} MiB, gradient_peak "
                  f"{r.get('gradient_peak_mib', 0.0):.1f} MiB above the "
                  f"params ({r['copy_mib']:.1f} MiB a copy), s/round "
                  "(gloo's host-staged wire) "
                  + ", ".join(f"{v:.4f}" for v in r["s_per_round"])
                  + f", launches {[nonzero(lc) for lc in r['launches']]}, "
                  f"isend bytes {r['sent']}")
        print(f"sharded: {name} remat={remat} peak summed over the ranks "
              f"{sum(s[remat]['peak_mib'] for s in stats):.1f} MiB")
    print(f"sharded: {name} bytes a round: {TP_RANK_BYTES:,} a rank "
          f"({TP_RANK_ROWS:,} rows), {root['full']['worker_cycle'][0]:,} a "
          f"worker (the reference's one-plan figure)")
    print(f"sharded: {name} max |Δparam| per round against a model axis of "
          f"1 from the same start {root['round_gaps']} (bar {TP_BAR}); "
          "remat 'full' against 'none': "
          + ("bit for bit" if all(s["remat_bitwise"] for s in stats) else
             f"max |Δ| per rank {[s['remat_gaps'] for s in stats]}"))
    for s in stats:
        for remat in ("full", "none"):
            r = s[remat]
            for lc in r["launches"]:
                if lc != {**{n: 0 for n in lc}, **TP_LAUNCHES}:
                    raise AssertionError(f"{name}: launches {lc}")
            if (r["used"] != TP_RANK_ROWS
                    or tuple(r["rank_cycle"]) != (TP_RANK_BYTES,)
                    or r["sent"] != [TP_RANK_BYTES] * TP_ROUNDS
                    or tuple(r["worker_cycle"]) != (TP_AXIS * TP_RANK_BYTES,)):
                raise AssertionError(
                    f"{name}: rank {s['rank']} used rows {r['used']}, isend "
                    f"bytes {r['sent']}, cycles {r['rank_cycle']} / "
                    f"{r['worker_cycle']}, expected {TP_RANK_BYTES}")
            if not all(math.isfinite(v) for v in r["losses"]):
                raise AssertionError(f"{name}: losses {r['losses']}")
        if max(s["remat_gaps"]) > TP_BAR:
            raise AssertionError(f"{name}: remat 'full' against 'none' "
                                 f"{s['remat_gaps']}")
    if len(root["round_gaps"]) != TP_ROUNDS or max(
            root["round_gaps"]) > TP_BAR:
        raise AssertionError(f"{name}: rounds against a model axis of 1 "
                             f"{root['round_gaps']}, bar {TP_BAR}")
    # the same model under inner="dp": the model axis splits the batch
    split_report(["sharded_olmo1b_dp2"], [s["dp"] for s in both])
    return stats


# the paths whose worker spans several ranks in other ways than
# ``sharded_olmo1b_tp2``'s TP of GQA: profile B's FSDP inside a worker
# (Qwen2-72B under its own profile B), TP of the MLA and SSD mixers, and
# profile A's ``inner="dp"``.  Each: the arch, its cuts, seq and batch a
# worker, the parallel config beside remat "full" and the ring, the mesh
# (named axes, the model axis) and the used rows of a rank's plan (the
# rank's shards at 4 B, handed once a round to its one ring(2)
# neighbour; ``tests/test_torch_fsdp.py`` holds them against the plan on
# meta tensors)
SPLIT = {
    # Qwen2-72B (arXiv:2407.10671): d_model 8,192, 64 heads, 8 KV heads,
    # d_ff 29,568, QKV bias, rope θ 1e6; 1 of 80 layers and the vocab cut
    # to 4,000 (at 152,064 the embedding and the head are 4.98 GB a leaf
    # in f32), as Mixtral's full-width path cuts them; 943.2 M params a
    # worker, 3.77 GB a copy, a rank's half 1.89 GB; K = 2 pods × an FSDP
    # axis of 2, one sequence a data rank; one round (a round moves about
    # 23 GB a rank through gloo's staging: 35-60 s on the card)
    "sharded_qwen2_72b_fsdp": dict(
        arch="qwen2-72b", cuts=dict(n_layers=1, vocab=4000), seq=256,
        batch=2, parallel=dict(profile="B"),
        mesh=((2, 2), ("pod", "data"), 1), rows=460_578, rounds=1),
    # MiniCPM3-4B's MLA at its full-width path's vocab, 2 of 62 layers:
    # 40 heads, 20 a rank; the latents' projections and norms whole
    "sharded_mla_tp2": dict(
        arch="minicpm3-4b", cuts=dict(n_layers=2, vocab=36_724), seq=256,
        batch=2, parallel=dict(profile="A"), mesh=((2,), ("data",), 2),
        rows=155_666),
    # Mamba2-1.3B's SSD, 2 of 48 layers, seq 1,024 (four chunks): 64
    # heads, 32 a rank; B and C (one group) whole
    "sharded_ssd_tp2": dict(
        arch="mamba2-1.3b", cuts=dict(n_layers=2), seq=1024, batch=1,
        parallel=dict(profile="A"), mesh=((2,), ("data",), 2),
        rows=126_324),
    # OLMo-1B at ``TP_OLMO``'s cuts under inner="dp": each rank of a
    # worker holds the whole worker and takes one of its two sequences,
    # and hands isend the worker's whole plan
    "sharded_olmo1b_dp2": dict(
        arch="olmo-1b", cuts=dict(n_layers=2), seq=2048, batch=2,
        parallel=dict(profile="A", inner="dp"), mesh=((2,), ("data",), 2),
        rows=299_520, rounds=1),
}
SPLIT_ROUNDS = 2            # a path's rounds unless it sets its own
SPLIT_LAUNCHES = {"momentum_update": P, "gossip_mix": 1}


def split_run(path: str):
    """The RunCfg of a ``SPLIT`` path: the arch at its cuts in f32, PD-SGDM
    at the full-width step on the kernel layout, ``remat="full"``."""
    from repro_torch.configs.base import OptimCfg, ParallelCfg, RunCfg
    from repro_torch.configs.registry import get_config
    spec = SPLIT[path]
    cfg = dataclasses.replace(get_config(spec["arch"]).model,
                              param_dtype="float32", compute_dtype="float32",
                              **spec["cuts"])
    return RunCfg(model=cfg,
                  parallel=ParallelCfg(remat="full", topology="ring",
                                       **spec["parallel"]),
                  optim=OptimCfg(name="pd_sgdm", use_kernel=True,
                                 **FULL_HYPER))


def split_stream(path: str, k: int):
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    spec = SPLIT[path]
    cfg = LMStreamCfg(vocab=spec["cuts"].get(
        "vocab", split_run(path).model.vocab), seq_len=spec["seq"],
        batch=spec["batch"], n_workers=k, seed=0)
    return lambda t: lm_batch(cfg, t, DEVICE)


def f32_ulp(torch, value: float) -> float:
    """The spacing of f32 numbers at ``|value|``."""
    v = torch.tensor(abs(value), dtype=torch.float32)
    return float(torch.nextafter(v, torch.tensor(math.inf)) - v)


def split_check(torch, path, held, k, dev):
    """Each held round (its end, whole, on the host) against the same
    round with one rank per worker (``DenseComm(ring(k))``, gradients
    worker by worker), from the round's captured start: round 0 from x₀
    (drawn again from seed 0, as every rank drew it) and zero momentum,
    round r from round r − 1's held end.  Returns max |Δparam| per
    round, and per round where it sits (its leaf, the value there and
    that value's f32 ulp, the four largest leaves' gaps)."""
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.models import make_model
    from repro_torch.train.trainer import _stack_batches
    run = split_run(path)
    model = make_model(run.model)
    grads_fn = per_worker_grads_fn(torch, model)
    dopt = make_optimizer("pd_sgdm", DenseComm(ring(k), device=dev),
                          use_kernel=True, **FULL_HYPER)
    stream = split_stream(path, k)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = {n: v.unsqueeze(0).expand((k,) + v.shape).contiguous()
         for n, v in model.init(gen, device=dev).items()}
    m = None
    gaps, worst = [], []
    for (t, want_x, want_m) in held:
        state = dopt.init(x)
        if m is not None:
            state["m"] = m
        state["step"].fill_(t)
        batches = _stack_batches([stream(t + i) for i in range(P)])
        got, state, _ = dopt.round(state, x, grads_fn, batches)
        del state, batches
        per = {n: (got[n] - want_x[n].to(dev)).abs() for n in got}
        leaf = max(per, key=lambda n: float(per[n].max()))
        at = int(per[leaf].argmax())
        value = float(want_x[leaf].reshape(-1)[at])
        gaps.append(float(per[leaf].max()))
        # where the largest gap sits: its leaf, the value there and that
        # value's f32 ulp, and the next leaves' largest gaps
        worst.append({
            "leaf": leaf, "value": value,
            "ulp": f32_ulp(torch, value),
            "leaves": dict(sorted(((n, float(v.max()))
                                   for n, v in per.items()),
                                  key=lambda kv: -kv[1])[:4])})
        del got, per
        # the next round starts where this one ended on the ranks
        x = {n: v.to(dev) for n, v in want_x.items()}
        m = ({n: v.to(dev) for n, v in want_m.items()}
             if want_m is not None else None)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return gaps, worst


def split_rank(mesh_rank, paths):
    """A rank of the ``SPLIT`` paths ``paths``, one after another: two
    rounds of each through ``ShardedTrainer`` (per round its launches,
    bytes, wall and the checksums of its end on this rank), the
    allocator peak and one step's ``gradient_peak``; each round's end
    (and, but for the last, its momentum) gathered whole to rank 0's
    host as it ends; then every rank frees the card and rank 0 holds each
    round against one rank per worker (``split_check``) while the others
    wait."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer, gather_workers
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    on_card = dev.type == "cuda"
    out = {}
    for path in paths:
        spec = SPLIT[path]
        n_rounds = spec.get("rounds", SPLIT_ROUNDS)
        sizes, names, model_axis = spec["mesh"]
        mesh = make_mesh(sizes, names, device=dev, model_axis=model_axis)
        pack = build_train(split_run(path), mesh)
        lay = pack.layout
        stream = split_stream(path, lay.n_workers)
        rounds, held = [], []
        stats = {"rank": rank, "worker": lay.worker_index,
                 "inner": lay.inner_index()}
        opt, grad_fn = pack.opt, pack.grad_fn

        def peak_grad_fn(params, batch):
            # the round's first step: its gradient's peak above all the
            # round holds at the step's start (one more step would cost
            # a step's whole wire)
            if not on_card or "gradient_peak_mib" in stats:
                return grad_fn(params, batch)
            sync(torch, dev)
            stats["peak_before"] = torch.cuda.max_memory_allocated(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = grad_fn(params, batch)
            sync(torch, dev)
            stats["gradient_peak_mib"] = (
                torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
            return out

        def kernel_round(params, state, batches, t):
            opt.host_step = int(t)
            return opt.round(state, params, peak_grad_fn, batches)
        pack.train_round = kernel_round
        watch_rounds(torch, pack, rounds, keep=False)
        inner = pack.train_round

        def train_round(params, state, batches, t, inner=inner):
            res = inner(params, state, batches, t)
            last = t + P >= n_rounds * P
            rounds[-1]["sums"] = bit_checksum(torch, res[0])
            held.append((t, gather_workers(res[0], True, lay, pack.plan),
                         None if last else gather_workers(
                             res[1]["m"], True, lay, pack.plan)))
            return res
        pack.train_round = train_round
        trainer = ShardedTrainer(pack)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        res = trainer.train(0, lambda t: pack.worker_batch(stream(t)),
                            n_rounds * P, log_every=P, verbose=False)
        peak = max(torch.cuda.max_memory_allocated(dev),
                   stats.pop("peak_before")) if on_card else 0
        plan = kops.KernelPlan.for_tree(res["params"], worker_dim=True)
        stats.update({
            "peak_mib": peak / 2 ** 20,
            "s_per_round": [r["s"] for r in rounds],
            "launches": [r["launches"] for r in rounds],
            "sent": [r["sent"] for r in rounds],
            "sums": [r["sums"] for r in rounds],
            "rank_cycle": trainer.rank_bytes_per_round_cycle(),
            "worker_cycle": trainer.bytes_per_round_cycle(),
            "used": plan.used_rows, "losses": res["history"].loss,
            "copy_mib": sum(v.numel() * 4 for v in
                            pack.params_struct.values()) / 2 ** 20})
        del plan
        k = lay.n_workers
        del res, pack, trainer, rounds, opt, grad_fn
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            t0 = time.perf_counter()
            stats["round_gaps"], stats["round_worst"] = split_check(
                torch, path, held, k, dev)
            stats["check_s"] = time.perf_counter() - t0
        del held
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        dist.barrier()
        out[path] = stats
    return out


def split_phase(torch, paths, label):
    """The ranks of ``paths`` (one mesh size; phase ``label``'s share of
    the shared spawn) and each path held (``split_report``)."""
    gc.collect()
    torch.cuda.empty_cache()
    sizes, _, model_axis = SPLIT[paths[0]]["mesh"]
    world = math.prod(sizes) * model_axis
    t0 = time.perf_counter()
    stats = spawn_shared(label)
    print(f"sharded: {label}: {world} ranks on one card (gloo), "
          f"{time.perf_counter() - t0:.1f} s with the spawn and the checks")
    split_report(paths, stats)
    return stats


def split_report(paths, stats):
    """Hold each ``SPLIT`` path of the ranks' ``stats``: per rank and round
    ``SPLIT_LAUNCHES`` on its shards and its plan's used rows at 4 B to
    ``isend``; each round within ``TP_BAR`` of the same round with one
    rank per worker from the same start; the ranks of a worker
    bit-identical where they hold replicas (``inner="dp"``); finite
    losses.  Prints each rank's peak, ``gradient_peak`` (one step's
    gradient above what the round holds at its start) and s/round."""
    for path in paths:
        spec, run = SPLIT[path], split_run(path)
        n_rounds = spec.get("rounds", SPLIT_ROUNDS)
        per = [s[path] for s in stats]
        root = per[0]
        want = spec["rows"] * 1024 * 4
        print(f"sharded: {path} PD-SGDM on {spec['arch']}'s widths, cuts "
              f"{spec['cuts']}, f32, seq {spec['seq']}, batch "
              f"{spec['batch']} a worker, mesh {spec['mesh'][1]} "
              f"{spec['mesh'][0]} × model axis {spec['mesh'][2]}, "
              f"{run.parallel.profile}/{run.parallel.inner}, remat "
              f"'{run.parallel.remat}', ring, p={P}, {n_rounds} "
              f"round(s); losses (the workers' mean) "
              + " ".join(f"{v:.4f}" for v in root["losses"]))
        for s in per:
            print(f"sharded: {path} rank {s['rank']} (worker {s['worker']},"
                  f" inner place {s['inner']}): peak {s['peak_mib']:.1f} "
                  f"MiB, gradient_peak {s.get('gradient_peak_mib', 0.0):.1f}"
                  f" MiB above the round's state ({s['copy_mib']:.1f} MiB a "
                  "copy),"
                  " s/round " + ", ".join(f"{v:.4f}"
                                          for v in s["s_per_round"])
                  + f", launches {[nonzero(lc) for lc in s['launches']]}, "
                  f"isend bytes {s['sent']}")
        print(f"sharded: {path} peak summed over the ranks "
              f"{sum(s['peak_mib'] for s in per):.1f} MiB; bytes a round "
              f"{want:,} a rank ({spec['rows']:,} rows), "
              f"{root['worker_cycle'][0]:,} a worker (the reference's "
              f"one-plan figure)")
        print(f"sharded: {path} max |Δparam| per round against one rank "
              f"per worker from the same start {root['round_gaps']} (bar "
              f"{TP_BAR}; the check {root['check_s']:.1f} s)")
        for r, w in enumerate(root["round_worst"]):
            print(f"sharded: {path} round {r}: the largest gap in "
                  f"{w['leaf']} at a value of {w['value']!r} (f32 ulp "
                  f"{w['ulp']!r}); the largest leaves' gaps {w['leaves']}")
        for s in per:
            for lc in s["launches"]:
                if lc != {**{n: 0 for n in lc}, **SPLIT_LAUNCHES}:
                    raise AssertionError(f"{path}: launches {lc}")
            if (s["used"] != spec["rows"]
                    or tuple(s["rank_cycle"]) != (want,)
                    or s["sent"] != [want] * n_rounds):
                raise AssertionError(
                    f"{path}: rank {s['rank']} used rows {s['used']}, isend "
                    f"bytes {s['sent']}, cycle {s['rank_cycle']}, expected "
                    f"{want}")
            if not all(math.isfinite(v) for v in s["losses"]):
                raise AssertionError(f"{path}: losses {s['losses']}")
        if run.parallel.inner == "dp":
            # the ranks of a worker hold the same bits after every round
            by_worker = {}
            for s in per:
                by_worker.setdefault(s["worker"], []).append(s["sums"])
            split = [w for w, sums in by_worker.items()
                     if any(x != sums[0] for x in sums)]
            print(f"sharded: {path} a worker's ranks bit-identical after "
                  f"every round: {not split}")
            if split:
                raise AssertionError(f"{path}: workers {split} diverged")
        if len(root["round_gaps"]) != n_rounds or max(
                root["round_gaps"]) > TP_BAR:
            raise AssertionError(f"{path}: rounds against one rank per "
                                 f"worker {root['round_gaps']}, bar {TP_BAR}")


def sharded_fsdp_phase(torch):
    """``sharded_qwen2_72b_fsdp``: PD-SGDM at Qwen2-72B's published widths
    under its own profile B, 2 pods on ring(2) × an FSDP axis of 2 (4
    ranks on the card): per layer each rank all-gathers its shards inside
    the repeat's pass (again in the recomputation) and sums the gradient
    back over the data axis leaf by leaf."""
    return split_phase(torch, ["sharded_qwen2_72b_fsdp"],
                       "sharded_qwen2_72b_fsdp")


def sharded_mla_ssd_phase(torch):
    """``sharded_mla_ssd_tp2``: MiniCPM3-4B's MLA and Mamba2-1.3B's SSD
    split by heads over a model axis of 2 (K = 2, 4 ranks, one spawn)."""
    return split_phase(torch, ["sharded_mla_tp2", "sharded_ssd_tp2"],
                       "sharded_mla_ssd_tp2")


def pretrain_sweep_phase(torch):
    """``pretrain_sweep_rows``: ``benchmarks/pretrain_sweep.py``'s training
    rows through the port's example (``examples/torch_pretrain_decentralized.py
    --quick``, 8 steps, its default 4 workers × a model axis of 2, 8 ranks
    on the card), the flat ring and hierarchical(2, 2) with the bf16 inter
    wire: each run's ``bytes_per_comm_round`` equal to the committed
    ``BENCH_pretrain.json``'s row, and ``claim_equal_loss`` (the hier final
    loss within 5 % of the flat one)."""
    import tempfile
    with open(os.path.join(ROOT, "benchmarks", "BENCH_pretrain.json")) as f:
        rows = {r["name"]: r["derived"] for r in json.load(f)["rows"]}
    recs = {}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sweep_") as d:
        for tag, extra in SWEEP_RUNS.items():
            out = os.path.join(d, f"{tag}.json")
            t1 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, os.path.join(ROOT, "examples",
                                              "torch_pretrain_decentralized.py"),
                 "--quick", "--steps", str(SWEEP_STEPS), "--device", DEVICE,
                 "--json-out", out] + extra,
                capture_output=True, text=True, timeout=400, cwd=ROOT,
                env=env)
            if r.returncode != 0:
                raise AssertionError(f"pretrain_sweep_rows {tag}: rc "
                                     f"{r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-4000:]}")
            with open(out) as f:
                recs[tag] = json.load(f)
            rec = recs[tag]
            print(f"sweep: pretrain_sweep_rows {tag}: {rec['model']}, "
                  f"{rec['workers']} workers × model axis "
                  f"{rec['model_axis']}, {rec['steps']} steps, loss "
                  f"{rec['first_loss']:.4f} -> {rec['final_loss']:.4f}, "
                  f"{rec['tokens_per_s']:.0f} tok/s, comm "
                  f"{rec['comm_mb']:.4f} MB/worker, bytes per round "
                  f"{rec['bytes_per_comm_round']:,} a worker (the "
                  f"reference's), per rank {rec['bytes_per_rank']}, "
                  f"{time.perf_counter() - t1:.1f} s with the spawn")
    missed = []
    for tag, rec in recs.items():
        want = rows[f"pretrain/train_{tag}"]["bytes_per_comm_round"]
        if rec["bytes_per_comm_round"] != want or not (
                math.isfinite(rec["first_loss"])
                and math.isfinite(rec["final_loss"])):
            missed.append((tag, rec["bytes_per_comm_round"], want))
    flat, hier = recs["flat"]["final_loss"], recs["hier"]["final_loss"]
    ok = hier <= 1.05 * flat
    print(f"sweep: pretrain_sweep_rows claim_equal_loss: hier final {hier:.4f}"
          f" against flat {flat:.4f} (within 5 %: {ok}), comm reduction "
          f"{recs['flat']['comm_mb'] / recs['hier']['comm_mb']:.2f}x")
    if not ok:
        missed.append(("claim_equal_loss", hier, flat))
    verdict("sweep: pretrain_sweep_rows", missed, t0)


# ---------------------------------------------------------------- serving
# the served models: published widths and depth (Mixtral cut to 2 of its
# 32 layers: its 46.7 B params are 93 GB in bf16, past the card's 80 GB),
# in the configs' own bf16; batch, prompt and new tokens within each
# model's published context (OLMo-1B 2,048; MiniCPM3-4B's 1,088 here;
# Mamba2-1.3B 2,048, its prompt 7 chunks of 256; Mixtral's prompt past its
# 4,096-slot window, so the prompt cache takes the roll and decode wraps
# the ring)
SERVE = {
    "olmo-1b": dict(cuts={}, batch=16, prompt=1920, new=128),
    "minicpm3-4b": dict(cuts={}, batch=8, prompt=1024, new=64),
    "mamba2-1.3b": dict(cuts={}, batch=16, prompt=1792, new=256),
    "mixtral-8x7b": dict(cuts=dict(n_layers=2), batch=2, prompt=4352,
                         new=128),
}
# the f32 parity runs' batch (TF32 off), over each model's lengths
SERVE_PARITY_BATCH = 2
# the bar of the served logits against ``Model.apply``'s (and of the
# sharded ranks' against one rank's): max |Δlogit| over max |logit|.
# prefill, decode and apply run f32 matmuls of other shapes (1 or s rows),
# whose sums take other orders: a few ulps a layer, through 16-62 layers;
# the bf16 configs alone move logits by about 2^-9 of their size
SERVE_BAR = 1e-4
# Mixtral's ring at the layer: max |Δy| over max |y|, as MLA_BAR
RING_BAR = 2e-5
# serve_sharded_olmo1b: OLMo-1B whole (16 layers, f32) on the serving
# mesh 2 ("data") x 2 ("model"), 4 gloo ranks, profile A: TP over the
# model axis, the batch over the data axis (2 rows a rank)
SERVE_SHARDED = dict(arch="olmo-1b", batch=4, prompt=512, new=32)
SMI = ""


def serve_cfg(arch: str, dtype: str):
    """The served config of ``arch``: the published one with ``SERVE``'s
    cuts, in ``dtype`` (its own bf16, or f32 for the parity runs)."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch).model,
                               param_dtype=dtype, compute_dtype=dtype,
                               **SERVE[arch]["cuts"])


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for c in cache.values()
               for t in c.values())


def watched_generate(torch, model, params, prompt, new: int,
                     keep: bool = False):
    """``generate`` (the port's loop) with the model's ``prefill_fast`` and
    ``decode_step`` each timed between synchronizes (host clock), their
    logits checked finite and, with ``keep``, kept: ``(tokens, stats,
    logits)``, the logits of the prefill and of every decode step (the
    teacher-forced logits of the tokens ``generate`` chose)."""
    from repro_torch.serve.serving import generate
    stats = {"prefill": [], "decode": [], "cache_bytes": None}
    kept = []

    def watch(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stats[name].append(time.perf_counter() - t0)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{model.cfg.name}: {name} logits "
                                     "not finite")
            if stats["cache_bytes"] is None:
                stats["cache_bytes"] = cache_bytes(cache)
            if keep:
                kept.append(logits.clone())
            return logits, cache
        return timed

    model.prefill_fast = watch("prefill", model.prefill_fast)
    model.decode_step = watch("decode", model.decode_step)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, params, prompt, new)
        torch.cuda.synchronize()
        stats["wall"] = time.perf_counter() - t0
    finally:
        del model.prefill_fast, model.decode_step
    b, s = prompt.shape
    if toks.shape != (b, s + new) or not torch.equal(toks[:, :s],
                                                     prompt.to(toks.dtype)):
        raise AssertionError(f"{model.cfg.name}: generate gave "
                             f"{tuple(toks.shape)}, or lost the prompt")
    if int(toks.min()) < 0 or int(toks.max()) >= model.cfg.vocab:
        raise AssertionError(f"{model.cfg.name}: a token off the vocab")
    return toks, stats, kept


def rel_gap(torch, got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def serve_parity(torch, arch, model, params, toks, kept, prompt_len):
    """The f32 run's logits against ``Model.apply``'s: the prefill's at the
    prompt's last position and each decode step's at its own, and the
    greedy tokens against apply's argmax where its top-2 gap exceeds the
    bar.  Mixtral: the prefill against apply over the prompt alone (its
    MoE's capacity follows the token count, so decode, b tokens a step,
    and apply over the sequence drop other slots by design)."""
    s = prompt_len
    if arch == "mixtral-8x7b":
        want = model.apply(params, {"tokens": toks[:, :s]})[0][:, -1]
        gap = rel_gap(torch, kept[0], want)
        print(f"serve: {arch} f32 parity: prefill_fast against apply over "
              f"the prompt {gap:.3e} of max |logit| (bar {SERVE_BAR:g})")
        if gap > SERVE_BAR:
            raise AssertionError(f"{arch}: prefill {gap} past {SERVE_BAR}")
        return
    full = model.apply(params, {"tokens": toks})[0]
    want = full[:, s - 1:-1]                    # predicts tokens s … end
    del full
    got = torch.stack(kept, dim=1)
    scale = float(want.abs().max())
    pre = float((got[:, 0] - want[:, 0]).abs().max()) / scale
    dec = float((got[:, 1:] - want[:, 1:]).abs().max()) / scale
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > SERVE_BAR * scale
    agree = want.argmax(-1) == toks[:, s:]
    print(f"serve: {arch} f32 parity: prefill_fast {pre:.3e}, decode_step "
          f"{dec:.3e} of max |logit| {scale:.3f} (bar {SERVE_BAR:g}); greedy "
          f"tokens equal apply's argmax at {int((agree & decisive).sum())} "
          f"of {int(decisive.sum())} decisive positions "
          f"({int((~decisive).sum())} within the bar)")
    if max(pre, dec) > SERVE_BAR or not bool((agree | ~decisive).all()):
        raise AssertionError(f"{arch}: served logits {pre}, {dec} past "
                             f"{SERVE_BAR}, or a greedy token off apply's")


def ring_layer_check(torch, params, cfg, prompt: int, new: int):
    """Mixtral's attention layer at published widths, f32: the prompt's
    ``attention_prefill`` into the 4,096-slot ring (the roll), then ``new``
    ``attention_decode`` steps wrapping it, each against
    ``attention_apply`` with the window over all the rows."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rope_freqs
    from repro_torch.models.transformer import Model
    acfg = Model(cfg).attn_cfg
    p = {n: {"w": params[f"blocks.pos0.attn.{n}.w"][0]}
         for n in ("wq", "wk", "wv", "wo")}
    n = prompt + new
    x = torch.randn((SERVE_PARITY_BATCH, n, acfg.d_model), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(5))
    cos, sin = rope_freqs(acfg.head_dim, n, acfg.rope_theta, device=DEVICE)
    with torch.no_grad():
        full = attn.attention_apply(p, x, acfg, cos, sin)
        y, cache = attn.attention_prefill(p, x[:, :prompt], acfg, cos, sin,
                                          n)
        scale = float(full.abs().max())
        pre = float((y - full[:, :prompt]).abs().max()) / scale
        dec = 0.0
        for i in range(prompt, n):
            y, cache = attn.attention_decode(p, x[:, i:i + 1], cache, i,
                                             acfg, cos, sin)
            dec = max(dec, float((y[:, 0] - full[:, i]).abs().max()) / scale)
    slots = cache["pos"].shape[1]
    lo, hi = int(cache["pos"].min()), int(cache["pos"].max())
    print(f"serve: mixtral-8x7b ring at the layer ({slots} slots, prompt "
          f"{prompt}, {new} decode steps, positions {lo}-{hi} held): "
          f"prefill {pre:.3e}, decode {dec:.3e} of max |y| (bar "
          f"{RING_BAR:g})")
    if max(pre, dec) > RING_BAR or (lo, hi) != (n - slots, n - 1):
        raise AssertionError(f"mixtral ring: {pre}, {dec} past {RING_BAR}, "
                             f"or positions {lo}-{hi}")


def profile_decode(torch, arch, model, params, prompt, total: int,
                   steps: int = 4):
    """``--profile``: ``steps`` bf16 decode steps after a prefill, timed
    alone (host clock between synchronizes) and then under the profiler:
    the device's kernel time a step against the step's wall (its busy
    share), and the top kernels; the table goes to
    ``decode_profile_<arch>.txt`` in the output directory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s = prompt.shape[1]
    steps = min(steps, (total - s - 1) // 2)
    tok = prompt[:, -1]
    with torch.no_grad():
        _, cache = model.prefill_fast(params, {"tokens": prompt},
                                      max_len=total)
        model.decode_step(params, cache, tok, s, max_positions=total)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            model.decode_step(params, cache, tok, s + 1 + i,
                              max_positions=total)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                model.decode_step(params, cache, tok, s + 1 + steps + i,
                                  max_positions=total)
            torch.cuda.synchronize()
    del cache
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6 / steps
    launches = sum(e.count for e in kernels) / steps
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"decode_profile_{arch}.txt"), "w") as f:
        f.write(events.table(sort_by=sort_key, row_limit=60))
    print(f"profile: {arch} bf16 decode step {wall * 1e3:.3f} ms wall, "
          f"kernels {busy * 1e3:.3f} ms on the device (busy "
          f"{100 * busy / wall:.1f} %), {launches:.0f} kernels a step")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"profile:   {dev_us(e) / 1e3 / steps:9.3f} ms a step  "
              f"x{e.count // steps:<5d} {e.key[:90]}")


def serve_full_width_phase(torch, profile: bool = False):
    """``serve_full_width``: ``generate`` on OLMo-1B, MiniCPM3-4B (MLA's
    compressed cache) and Mamba2-1.3B (the SSM state) whole, and
    Mixtral-8x7B's 2 layers (the ring and the MoE), at published widths in
    bf16 (``SERVE``): prefill ms, decode ms a token, tok/s, peak memory and
    cache bytes; then each in f32 at a batch of ``SERVE_PARITY_BATCH``
    against ``Model.apply`` (``serve_parity``) and Mixtral's ring at the
    layer (``ring_layer_check``).  Serving launches none of the ten
    kernels.  With ``profile`` (``--profile``) also
    :func:`profile_decode` on each bf16 model."""
    from repro_torch.models import make_model
    t0 = time.perf_counter()
    kernels = reset_counters()
    for arch, run in SERVE.items():
        t1 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        cfg = serve_cfg(arch, "bfloat16")
        model = make_model(cfg)
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
        prompt = torch.randint(
            0, cfg.vocab, (run["batch"], run["prompt"]), device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.reset_peak_memory_stats()
        toks, st, _ = watched_generate(torch, model, params, prompt,
                                       run["new"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        dec = st["decode"]
        print(f"serve: {arch} bf16, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}, batch {run['batch']}, "
              f"prompt {run['prompt']}, {run['new']} new: prefill "
              f"{1e3 * st['prefill'][0]:.2f} ms, decode "
              f"{1e3 * statistics.median(dec):.3f} ms a token (median of "
              f"{len(dec)}; {1e3 * min(dec):.3f}-{1e3 * max(dec):.3f}), "
              f"{run['batch'] * run['new'] / st['wall']:.1f} tok/s over "
              f"{st['wall']:.2f} s, peak {peak:,.1f} MiB, cache "
              f"{st['cache_bytes']:,} B, params "
              f"{sum(v.numel() for v in params.values()):,}, on {SMI}")
        if profile:
            profile_decode(torch, arch, model, params, prompt,
                           run["prompt"] + run["new"])
        # the parity run: the same params in f32 (the bf16 values)
        params = {k: v.float() for k, v in params.items()}
        cfg32 = serve_cfg(arch, "float32")
        model = make_model(cfg32)
        prompt = prompt[:SERVE_PARITY_BATCH]
        toks, st, kept = watched_generate(torch, model, params, prompt,
                                          run["new"], keep=True)
        with torch.no_grad():
            serve_parity(torch, arch, model, params, toks, kept,
                         run["prompt"])
        if arch == "mixtral-8x7b":
            ring_layer_check(torch, params, cfg32, run["prompt"], run["new"])
        del params, toks, kept, model
        print(f"serve: {arch} {time.perf_counter() - t1:.1f} s")
    launched = {n: fn.launches for n, fn in kernels.items() if fn.launches}
    if launched:
        raise AssertionError(f"serving launched {launched}")
    print(f"serve: serve_full_width launched none of the ten kernels, "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()


def serve_sharded_run():
    from repro_torch.configs.base import ParallelCfg, RunCfg
    from repro_torch.configs.registry import get_config
    run = get_config(SERVE_SHARDED["arch"])
    return RunCfg(model=dataclasses.replace(run.model,
                                            param_dtype="float32",
                                            compute_dtype="float32"),
                  parallel=ParallelCfg(profile="A"), optim=run.optim)


def serve_sharded_rank(mesh_rank, prompt):
    """A rank of ``serve_sharded_olmo1b``: ``build_serve`` on the 2 × 2
    serving mesh, its shards of the params from seed 0, and
    ``ServePack.generate`` over the whole prompt (its 2 rows), the bytes it
    hands to ``all_reduce`` counted per prefill and decode step; returns
    the tokens, (rank 0) the gathered logits of every step, the bytes, the
    step times and its peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_serve
    rank, world, dev = mesh_rank
    rank_setup(torch, dev)
    mesh = make_mesh((2,), ("data",), device=dev, model_axis=2)
    n = SERVE_SHARDED["prompt"] + SERVE_SHARDED["new"]
    pack = build_serve(serve_sharded_run(), mesh,
                       InputShape("serve", n, SERVE_SHARDED["batch"],
                                  "decode"))
    params = pack.init_fn(0)
    reduced, kept = [0], []
    plain_reduce, plain_gather = mesh.all_reduce, pack.gather

    def counted(t, group, op=dist.ReduceOp.SUM):
        reduced[0] += t.numel() * t.element_size()
        return plain_reduce(t, group, op)

    def gather(t):
        out = plain_gather(t)
        if rank == 0:
            kept.append(out.cpu())
        return out

    steps = {"prefill": [], "decode": []}

    def watch(name, fn):
        def timed(*args):
            sync(torch, dev)
            before, t0 = reduced[0], time.perf_counter()
            out = fn(*args)
            sync(torch, dev)
            steps[name].append((time.perf_counter() - t0,
                                reduced[0] - before))
            return out
        return timed

    mesh.all_reduce, pack.gather = counted, gather
    pack.prefill_step = watch("prefill", pack.prefill_step)
    pack.decode_step = watch("decode", pack.decode_step)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    toks = pack.generate(params, torch.as_tensor(prompt, device=dev),
                         SERVE_SHARDED["new"])
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
            if dev.type == "cuda" else 0.0)
    return {"rank": rank, "tokens": toks.cpu(),
            "logits": torch.stack(kept, 1) if kept else None,
            "steps": steps, "peak_mib": peak,
            "rows": (pack.rows.start, pack.rows.stop),
            "copy_mib": sum(v.numel() * 4 for v in
                            pack.params_struct.values()) / 2 ** 20}


def serve_sharded_prompt():
    """``serve_sharded_olmo1b``'s prompt tokens, from seed 3 on the host."""
    import torch
    return torch.randint(0, serve_sharded_run().model.vocab,
                         (SERVE_SHARDED["batch"], SERVE_SHARDED["prompt"]),
                         generator=torch.Generator().manual_seed(3))


def serve_sharded_phase(torch):
    """``serve_sharded_olmo1b``: OLMo-1B whole in f32 on the serving mesh 2
    ("data") × 2 ("model"), 4 gloo ranks on the card (``build_serve``:
    each rank its TP shards and 2 of the 4 rows), greedy; the gathered
    tokens equal one rank's ``generate``, the logits within ``SERVE_BAR``
    of its; the bytes each rank hands to ``all_reduce`` a decode step (the
    vocab-parallel embedding's and two row-parallel sums a layer) equal
    their count from the shapes."""
    from repro_torch.models import make_model
    t0 = time.perf_counter()
    cfg = serve_sharded_run().model
    b, s, new = (SERVE_SHARDED[k] for k in ("batch", "prompt", "new"))
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn_shared("serve_sharded_olmo1b")
    spawn_s = time.perf_counter() - t0
    model = make_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    want, _, kept = watched_generate(torch, model, params,
                                     serve_sharded_prompt().to(DEVICE), new,
                                     keep=True)
    want, want_logits = want.cpu(), torch.stack(kept, 1).cpu()
    del params, model, kept
    gc.collect()
    torch.cuda.empty_cache()
    rows = b // 2
    # a decode step: the embedding's (rows, 1, d) f32 sum and, per layer,
    # the attention's and the MLP's row-parallel sums of the same shape
    per_step = (1 + 2 * cfg.n_layers) * rows * cfg.d_model * 4
    missed = []
    for r in ranks:
        pre = r["steps"]["prefill"][0]
        dec = r["steps"]["decode"]
        print(f"serve: serve_sharded_olmo1b rank {r['rank']} rows "
              f"{r['rows']}: a copy of its params {r['copy_mib']:,.1f} MiB, "
              f"peak {r['peak_mib']:,.1f} MiB; prefill {1e3 * pre[0]:.1f} "
              f"ms, {pre[1]:,} B to all_reduce; decode "
              f"{1e3 * statistics.median(d[0] for d in dec):.2f} ms a step "
              f"(median of {len(dec)}), {dec[0][1]:,} B to all_reduce a "
              f"step (expected {per_step:,}); on {SMI}")
        if not torch.equal(r["tokens"], want):
            missed.append(("tokens", r["rank"]))
        if any(d[1] != per_step for d in dec) or pre[1] != per_step * s:
            missed.append(("all_reduce bytes", r["rank"]))
    gap = rel_gap(torch, ranks[0]["logits"], want_logits)
    print(f"serve: serve_sharded_olmo1b tokens equal one rank's on every "
          f"rank: {all(torch.equal(r['tokens'], want) for r in ranks)}; "
          f"logits {gap:.3e} of max |logit| from one rank's (bar "
          f"{SERVE_BAR:g}); the ranks' results {spawn_s:.1f} s after "
          "the phase began (a spawn where none was shared)")
    if gap > SERVE_BAR:
        missed.append(("logits", gap))
    verdict("serve: serve_sharded_olmo1b", missed, t0)


# the kernels the fast dense grid's kernel rounds launch on the card
CONTRACT_KERNELS = ("momentum_update", "gossip_mix", "sign_pack",
                    "sign_unpack", "row_gather", "row_scatter")


def sync_mode_control(torch) -> str:
    """One PD-SGDM kernel round (K = 8 ring, the toy params) whose
    ``grads_fn`` reads a value with ``.item()``, checked as the grid's
    rounds are: the error ``set_sync_debug_mode("error")`` raised (on the
    card), else the op log's host-read violation; "" if neither saw it."""
    from repro_torch.analysis import round_check as rc
    from repro_torch.core import DenseComm, make_optimizer, ring
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device=DEVICE),
                         eta=0.05, mu=0.9, p=3, use_kernel=True)
    params = rc.toy_params(K, device=DEVICE)
    state = opt.init(params)
    batches = rc.toy_batches(3, K, DEVICE)
    params, state, _ = opt.round(state, params, rc.toy_grads_fn, batches)

    def reads(params, batch):
        loss, grads = rc.toy_grads_fn(params, batch)
        host = float(batch["x"].sum().item())
        return loss, {k: g + host for k, g in grads.items()}
    rec = rc.trace_round(opt, params, state, batches, grads_fn=reads,
                         sync_debug=DEVICE == "cuda")
    if rec.sync_error:
        return f"set_sync_debug_mode raised: {rec.sync_error[:80]}"
    found = rc.check_no_host_sync(rec)
    return f"the op log: {found[0][:80]}" if found else ""


def contracts_phase(torch, tp_stats=None):
    """``contracts``: the round contract on the card, and the dry run
    against a measured run.

    (a) The fast dense grid of ``python -m repro_torch.analysis.run``
    (``phase_dense``) with ``--device cuda``: each combination's checked
    round under ``torch.cuda.set_sync_debug_mode("error")``, its line
    ``ok`` or ``FAIL`` and the kernels its two rounds launched; every
    kernel of ``CONTRACT_KERNELS`` launches somewhere in the grid.

    (b) ``sharded_olmo1b_tp2``'s ``RunCfg`` (``tp_run("full")``) run for
    one round on meta, rank 0 of a 4-rank fake group, in a process of its
    own (``repro_torch.launch.dryrun.meta_step``): its bytes a round
    handed to ``isend`` equal what rank 0 of the measured phase handed
    (``tp_stats``, when that phase ran in this call), else rank 0's
    accounted ``bytes_per_comm_round``; its predicted peak a rank beside
    the measured one, and their ratio (a finding, not a gate)."""
    from repro_torch.analysis.round_check import kernel_launches
    from repro_torch.analysis.run import phase_dense
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import meta_step, run_in_process
    t0 = time.perf_counter()
    print(f"contracts: (a) the fast dense grid on {SMI}, each checked round "
          "under set_sync_debug_mode('error')")
    before = kernel_launches()
    failures = phase_dense(False, device=DEVICE)
    after = kernel_launches()
    launched = {n: after[n] - before[n] for n in after}
    print("contracts: (a) the grid's launches "
          + ", ".join(f"{n} {c}" for n, c in launched.items() if c))
    missed = [f"{label}: {v}" for label, v in failures]
    missed += [f"{n} never launched" for n in CONTRACT_KERNELS
               if not launched[n]]
    # the sync mode's control: the same check on a round whose gradient
    # reads a value on the host must fail, by the mode's own error
    caught = sync_mode_control(torch)
    print(f"contracts: (a) control, an .item() in grads_fn: "
          f"{caught or 'NOT caught'}")
    if not caught:
        missed.append("the sync debug mode missed a seeded .item()")

    run = tp_run("full")
    shape = InputShape("sharded_olmo1b_tp2", TP_OLMO["seq"],
                       TP_K * TP_OLMO["batch"], "train")
    t1 = time.perf_counter()
    got = run_in_process(meta_step, run, run.model, shape, (TP_K,),
                         ("data",), TP_AXIS)
    sent = int(got["collective_wire_bytes"].get("collective-permute", 0))
    mem = got["memory"]
    predicted = (mem["argument_bytes"] + mem["temp_bytes"]) / 2 ** 20
    print(f"contracts: (b) sharded_olmo1b_tp2 on meta, rank 0 of a 4-rank "
          f"fake group ({time.perf_counter() - t1:.1f} s with the spawn): "
          f"{sent:,} B a round to isend, collectives "
          f"{got['collective_counts']}, arguments "
          f"{mem['argument_bytes'] / 2 ** 20:.1f} MiB, temps "
          f"{mem['temp_bytes'] / 2 ** 20:.1f} MiB")
    if tp_stats is not None:
        measured = tp_stats[0]["full"]["sent"]
        print(f"contracts: (b) rank 0 of the measured sharded_olmo1b_tp2 "
              f"handed {measured} B a round to isend")
        if any(int(m) != sent for m in measured):
            missed.append(f"dry-run bytes {sent} != measured {measured}")
        peak = tp_stats[0]["full"]["peak_mib"]
        print(f"contracts: (b) predicted peak a rank {predicted:.1f} MiB, "
              f"measured {peak:.1f} MiB (rank 0, remat='full'), predicted "
              f"/ measured {predicted / peak:.3f}, on {SMI}")
    else:
        accounted = int(got["bytes_per_comm_round"])
        print(f"contracts: (b) sharded_olmo1b_tp2 did not run in this call: "
              f"compared against rank 0's accounted bytes_per_comm_round "
              f"{accounted:,} B; predicted peak a rank {predicted:.1f} MiB "
              f"(no measured peak)")
        if accounted != sent:
            missed.append(f"dry-run bytes {sent} != accounted {accounted}")
    verdict("contracts", missed, t0)


def gloo_cuda_probe(mesh_rank):
    """Whether gloo's send/recv take a CUDA tensor (run apart from the
    script, in a child that may crash: ``--probe-gloo``)."""
    import torch
    import torch.distributed as dist
    rank, world, dev = mesh_rank
    t = torch.full((4,), float(rank), device=dev)
    if rank == 0:
        dist.send(t, 1)
        return None
    dist.recv(t, 0)
    return t.cpu().tolist()


def _kernels(torch, ctx):
    ops, bw, peak = ctx["ops"], ctx["bw"], ctx["f32_peak"]
    t = ctx["timings"]
    t.update(kernel_phase(torch, ops, bw, peak))
    t.update(codec_kernel_phase(torch, ops, bw, peak))
    t.update(topk_kernel_phase(torch, ops, bw, peak))
    t.update(row_kernel_phase(torch, ops, bw, peak, ctx["variants"]))
    for path in FULL_WIDTH:
        for name, row in full_width_kernel_phase(torch, ops, bw, peak,
                                                 path).items():
            ctx["full_width"].setdefault(name, []).append(row)


def _training(torch, ctx):
    ctx["runs"] = {path: training_phase(torch, path) for path in PATHS}


def _parity(torch, ctx):
    for path in PATHS:
        parity_phase(torch, path)


def _layers(torch, ctx):
    moe_layer_phase(torch)
    mla_layer_phase(torch)
    ssd_layer_phase(torch)


def _sharded_olmo(torch, ctx):
    ctx["pd_olmo"] = sharded_olmo_phase(torch)


def _codec_olmo(torch, ctx):
    sharded_cpd_olmo_phase(torch, ctx["pd_olmo"])


# every phase by name, in the order a plain invocation runs them; the
# kernels line needs "kernels" and "training"
PHASES = {
    "kernels": _kernels,
    "training": _training,
    "parity": _parity,
    "layers": _layers,
    "dispatch": lambda torch, ctx: gossip_dispatch_phase(torch),
    "fig1": lambda torch, ctx: fig1_phase(torch),
    "fig2": lambda torch, ctx: fig2_phase(torch),
    "fig3": lambda torch, ctx: fig3_phase(torch),
    "noniid": lambda torch, ctx: noniid_phase(torch),
    "elastic": lambda torch, ctx: elastic_phase(torch),
    "topology": lambda torch, ctx: topology_phase(torch),
    "sharded_olmo1b": _sharded_olmo,
    "sharded_resnet_pd": lambda torch, ctx: sharded_resnet_phase(torch),
    "sharded_tinylm_hier_sign": lambda torch, ctx: sharded_hier_phase(torch),
    "sharded_resume": lambda torch, ctx: sharded_resume_phase(torch),
    "sharded_olmo1b_cpd_sign": _codec_olmo,
    "sharded_resnet_cpd": lambda torch, ctx: sharded_resnet_cpd_phase(torch),
    "sharded_embedding_cpd_sparse":
        lambda torch, ctx: sharded_embedding_phase(torch),
    "sharded_olmo1b_tp2": lambda torch, ctx: ctx.update(
        tp_olmo=sharded_tp_phase(torch)),
    "pretrain_sweep_rows": lambda torch, ctx: pretrain_sweep_phase(torch),
    "sharded_qwen2_72b_fsdp": lambda torch, ctx: sharded_fsdp_phase(torch),
    "sharded_mla_ssd_tp2": lambda torch, ctx: sharded_mla_ssd_phase(torch),
    "serve_full_width": lambda torch, ctx: serve_full_width_phase(
        torch, ctx["profile"]),
    "serve_sharded_olmo1b": lambda torch, ctx: serve_sharded_phase(torch),
    "contracts": lambda torch, ctx: contracts_phase(torch,
                                                    ctx.get("tp_olmo")),
}


def select_phases(spec: str) -> list:
    """The phases of ``--phases`` (comma-separated names, or "all"), in
    the script's order; an unknown name raises."""
    if spec == "all":
        return list(PHASES)
    names = [n.strip() for n in spec.split(",") if n.strip()]
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; choose from "
                         f"{', '.join(PHASES)}")
    return [n for n in PHASES if n in names]


def main(argv=None) -> int:
    global CHOSEN, SMI
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one round of each path into the "
                         "output directory")
    ap.add_argument("--gather-variant", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="also build the row_gather.cu at PATH (outside "
                         "the checkout's build), check it and time it "
                         "beside the checkout's gather in this call; with "
                         "--profile, also profile a sparse round with it")
    ap.add_argument("--probe-gloo", action="store_true",
                    help="only ask whether gloo's send/recv take a CUDA "
                         "tensor (two ranks; a crash is the answer no)")
    ap.add_argument("--phases", default="all",
                    help="comma-separated phases to run, in the script's "
                         "order (default all): " + ", ".join(PHASES))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build, ops
    except ModuleNotFoundError as err:
        if err.name != "repro_torch":
            raise
        print("chip_smoke: cannot import the port (repro_torch): the script "
              "runs from the root of a checkout of the repository, which "
              "holds the port in src/repro_torch", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    SMI = smi
    if args.probe_gloo:
        try:
            got = spawn(gloo_cuda_probe, 2)[1]
            print(f"probe: gloo send/recv of a CUDA tensor: received {got}")
        except Exception as err:        # the answer, not a failure
            print(f"probe: gloo send/recv of a CUDA tensor fails: "
                  f"{type(err).__name__}: {err}")
        return 0
    bw, f32_peak = peaks(torch.cuda.get_device_name(0))
    chosen = select_phases(args.phases)
    CHOSEN = tuple(chosen)
    skipped = [n for n in PHASES if n not in chosen]
    if skipped:
        print(f"phases: running {', '.join(chosen)}; skipped "
              f"{', '.join(skipped)}")

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc for "
          f"{', '.join(sorted(logs)) or 'nothing (cached)'}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(w in line for w in PTXAS_WORDS):
                print(f"build: {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = {"ops": ops, "bw": bw, "f32_peak": f32_peak, "timings": {},
           "profile": args.profile,
           "full_width": {}, "runs": None, "pd_olmo": None,
           "variants": [(label, build_variant(path)) for label, path in
                        (v.split("=", 1) for v in args.gather_variant)]}
    walls = {}
    for name in chosen:
        t0 = time.perf_counter()
        PHASES[name](torch, ctx)
        walls[name] = time.perf_counter() - t0
    codec = ("sharded_olmo1b_cpd_sign", "sharded_resnet_cpd",
             "sharded_embedding_cpd_sparse")
    if all(n in walls for n in codec):
        print(f"sharded: the codec phases ({', '.join(codec)}) "
              f"{sum(walls[n] for n in codec):.1f} s")
    print("phases: wall s " + ", ".join(f"{n} {w:.1f}"
                                        for n, w in walls.items()))
    if args.profile and "training" in chosen:
        for path in PATHS:
            profile_round(torch, path)
        gather_in_round(torch, ctx["variants"])
    timings, full_width, runs = ctx["timings"], ctx["full_width"], ctx["runs"]
    if not timings or runs is None:
        print("phases: no kernels line (the kernel and training phases "
              "make it)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kernels = []
    for name, (src, tpu) in SOURCES.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": runs[OWNER[name]][name],
            "max_abs_err": t["max_abs_err"], "max_ulp": t["max_ulp"],
            "ms": t["ms"], **({"inplace_ms": t["inplace_ms"]}
                              if "inplace_ms" in t else {}),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        if name in full_width:
            kernels[-1]["full_width"] = full_width[name]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
