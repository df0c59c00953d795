"""Collective-traffic diagnosis: the top collectives of one production
step by wire bytes × count, each with the site that posted it.

Port of ``src/repro/launch/diagnose.py:61-101``.  The reference attributes
each HLO collective through its ``op_name`` metadata and multiplies it by
its loop trips; the port runs the step on meta (:func:`repro_torch.launch.
dryrun.meta_step`), and the recorder names the calling module and
function of every executed call (the attention's out-projection all-reduce
is ``models.layers:_ReduceFromModel.forward``, the gossip's sends
``core.gossip:ShardedComm._mix_with``, …).

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch arctic-480b \\
      --shape train_4k --top 15
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_config, long_ctx_variant
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import meta_step, production_mesh, \
    run_in_process

__all__ = ["main", "top_collectives"]


def top_collectives(arch: str, shape_name: str, multi_pod: bool = False,
                    overrides=None, top: int = 15):
    """``(rows, total wire bytes a rank)`` of one step of ``arch`` at
    ``shape_name`` on the production mesh: the largest ``top`` groups of
    collectives (op, site, group, payload) by wire bytes × count."""
    shape = SHAPES[shape_name]
    run = get_config(arch)
    if overrides:
        run = overrides(run)
    mcfg = (long_ctx_variant(run.model) if shape_name == "long_500k"
            else run.model)
    sizes, names, tp = production_mesh(multi_pod)
    got = run_in_process(meta_step, run, mcfg, shape, sizes, names, tp, top)
    return got["top_collectives"], got["wire_bytes_per_device"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    rows, total = top_collectives(args.arch, args.shape, args.multi_pod,
                                  top=args.top)
    print(f"total wire: {total / 1e9:.1f} GB a rank (executed calls, no "
          "loop multiplier)")
    for r in rows:
        print(f"  {r['wire_total'] / 1e9:8.2f} GB  {r['op']:<19} "
              f"x{r['count']:<4} grp={r['group']:<3} "
              f"{r['bytes'] / 2 ** 20:9.1f} MB/call {r['dtype']:<8} "
              f"{r['axes'] or '-':<9} {r['site']}")


if __name__ == "__main__":
    main()
