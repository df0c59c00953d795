"""Tagged variants of the chosen (arch, shape) pairs through the dry run.

Port of ``src/repro/launch/hillclimb.py``: the same ``PAIRS`` of config
deltas over the paper-faithful baseline, each run through the port's
:func:`~repro_torch.launch.dryrun.run_one` and written with its tag into
``artifacts/hillclimb_torch/``.  ``attn_ctx_shard`` and
``moe_token_shard`` are GSPMD hints of the reference that the port reads
nowhere (ROADMAP A.12b.4), and ``ssm_bcast_groups`` reaches no layer of
the port (``models/mamba2.py``); ``moe_groups`` is read (the MoE's
dispatch groups).  A variant made of unread fields alone runs the
baseline's step: the tool prints where a variant's record equals its
baseline's.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair olmo
  PYTHONPATH=src python -m repro_torch.launch.hillclimb            # all pairs
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch.dryrun import run_one

__all__ = ["PAIRS", "main", "same_as_baseline"]

# the fields of a record that a config delta can move
COMPARED = ("n_workers", "optimizer", "p", "flops_per_device",
            "bytes_per_device", "collective_counts",
            "collective_result_bytes", "wire_bytes_per_device", "memory")


def _opt(name):
    def f(run):
        return dataclasses.replace(
            run, optim=dataclasses.replace(run.optim, name=name))
    return f


def _par(**kw):
    def f(run):
        return dataclasses.replace(
            run, parallel=dataclasses.replace(run.parallel, **kw))
    return f


def _model(**kw):
    def f(run):
        return dataclasses.replace(
            run, model=dataclasses.replace(run.model, **kw))
    return f


def _chain(*fns):
    def f(run):
        for fn in fns:
            run = fn(run)
        return run
    return f


PAIRS = {
    # --- adoption sweep: validated levers applied to further pairs ---
    "mixtral-adopt": ("mixtral-8x7b", "train_4k", [
        ("adopt_ctx_moe", _chain(_model(moe_groups=16),
                                 _par(attn_ctx_shard=True,
                                      moe_token_shard=True))),
    ]),
    "qwen2-adopt": ("qwen2-72b", "train_4k", [
        ("adopt_ctx", _par(attn_ctx_shard=True)),
    ]),
    "musicgen-adopt": ("musicgen-medium", "train_4k", [
        ("adopt_worker", _par(inner="worker", topology="torus")),
        ("adopt_worker_cpd", _chain(_par(inner="worker", topology="torus"),
                                    _opt("cpd_sgdm"))),
    ]),
    "stablelm-adopt": ("stablelm-12b", "train_4k", [
        ("adopt_ctx", _par(attn_ctx_shard=True)),
        ("adopt_ctx_dp", _par(attn_ctx_shard=True, inner="dp")),
    ]),
    "jamba-prefill-adopt": ("jamba-1.5-large-398b", "decode_32k", [
        ("adopt_moe_groups", _chain(_model(moe_groups=16),
                                    _par(moe_token_shard=True))),
    ]),
    # most representative of the paper's technique (profile-A gossip)
    "olmo": ("olmo-1b", "train_4k", [
        ("cpd_sign", _opt("cpd_sgdm")),
        ("inner_dp", _par(inner="dp")),
        ("inner_dp_cpd", _chain(_par(inner="dp"), _opt("cpd_sgdm"))),
        ("inner_dp_cpd_p16", _chain(
            _par(inner="dp"), _opt("cpd_sgdm"),
            lambda r: dataclasses.replace(
                r, optim=dataclasses.replace(r.optim, p=16)))),
        ("worker_per_chip", _par(inner="worker", topology="torus")),
        ("worker_per_chip_cpd", _chain(
            _par(inner="worker", topology="torus"), _opt("cpd_sgdm"))),
    ]),
    # worst roofline fraction: collective-bound MoE training
    "arctic": ("arctic-480b", "train_4k", [
        ("ctx_attn", _par(attn_ctx_shard=True)),
        ("ctx_attn_moe", _par(attn_ctx_shard=True, moe_token_shard=True)),
        ("ctx_moe_groups", _chain(_model(moe_groups=16),
                                  _par(attn_ctx_shard=True,
                                       moe_token_shard=True))),
        ("ctx_moe_noremat", _chain(_model(moe_groups=16),
                                   _par(attn_ctx_shard=True,
                                        moe_token_shard=True,
                                        remat="none"))),
    ]),
    # most collective-bound serving pair
    "jamba": ("jamba-1.5-large-398b", "prefill_32k", [
        ("ssm_bcast", _model(ssm_bcast_groups=True)),
        ("ssm_bcast_ctx", _chain(_model(ssm_bcast_groups=True),
                                 _par(attn_ctx_shard=True))),
        ("moe_groups", _chain(_model(moe_groups=16),
                              _par(moe_token_shard=True))),
        ("moe_groups_ctx", _chain(_model(moe_groups=16,
                                         ssm_bcast_groups=True),
                                  _par(attn_ctx_shard=True,
                                       moe_token_shard=True))),
    ]),
}


def same_as_baseline(record: dict, base: dict) -> bool:
    """Whether a variant's record equals its baseline's on every field a
    config delta can move (:data:`COMPARED`)."""
    return all(record.get(k) == base.get(k) for k in COMPARED)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pair", choices=list(PAIRS), default=None)
    ap.add_argument("--tag", default=None, help="run a single variant")
    ap.add_argument("--outdir", default="artifacts/hillclimb_torch")
    args = ap.parse_args(argv)

    pairs = [args.pair] if args.pair else list(PAIRS)
    for p in pairs:
        arch, shape, variants = PAIRS[p]
        base = run_one(arch, shape, False, args.outdir, tag="baseline")
        for tag, ov in variants:
            if args.tag and tag != args.tag:
                continue
            try:
                rec = run_one(arch, shape, False, args.outdir, overrides=ov,
                              tag=tag)
            except RuntimeError as e:    # a variant the port refuses (C.9)
                print(f"hillclimb: {p}/{tag} did not run: "
                      f"{str(e).strip().splitlines()[-1][:200]}")
                continue
            if same_as_baseline(rec, base):
                print(f"hillclimb: {p}/{tag} equals its baseline (the "
                      "delta changes nothing the port reads)")


if __name__ == "__main__":
    main()
