"""The readings the limits of a cell are set from, on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control 3] [--out <file>]

For each seed, in one process and on one program object: the program's
first rounds against the f32 reference (the sound runs: the lower
readings); and for the first ``--control`` seeds the control (the
reference itself in TF32 in the program's place) and the faults a
training cell can have, planted in the reference in the program's place
(half of each batch left out, the exchange left out) against the f32
reference: the upper readings.  A state left unchanged reads 1 by the
judge's measure and needs no run.  Prints one JSON line a seed and writes
them all to ``--out``.  The benchmark's own runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))
# as bench/run.py runs the program
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

FAULTS = ("half_batch", "no_exchange")


def calibrate(cell, seeds, control: int, device, log=print) -> list:
    from bench import harness, judge
    harness.f32_only()
    rows = []
    setup = None
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if setup is None:
            setup = harness.Setup(cell, seed, device)
        else:
            setup.seed = seed
        stream = setup.stream(setup.check_steps)
        prog, x = harness.program_readings(setup, stream)
        del x
        harness.free(device)
        t1 = time.perf_counter()
        ref = harness.reference_readings(setup, stream)
        t2 = time.perf_counter()
        row = {"seed": seed, "sound": judge.numbers(prog, ref),
               "program_s": t1 - t0, "reference_s": t2 - t1,
               "loss": prog["loss"]}
        if i < control:
            row["control_tf32"] = judge.numbers(
                harness.reference_readings(setup, stream, "tf32"), ref)
            for f in FAULTS:
                row[f] = judge.numbers(
                    harness.reference_readings(setup, stream, fault=f), ref)
        harness.free(device)
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from bench import harness, spec
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = calibrate(cell, seeds, args.control, "cuda",
                     log=lambda m: print(m, flush=True))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": cell.name, "rows": rows,
                       "card": harness.power_limit(),
                       "seconds": time.perf_counter() - T_START}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
