"""Run one cell of ``BENCHMARK.json`` on the card this process starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` times one window of whole rounds and reports the cell's
end-to-end metrics; ``--trace 1`` profiles a short window and reports its
per-layer metrics, with ``busy_s``, ``window_s`` and a breakdown.  Both
check what the program produced against the plain reference and print
each number compared beside its limit, as the last lines of standard
error and under ``checks`` at the end of the result, which is the last
line of standard output.  Exits non-zero, printing no result, without a
CUDA card (or fewer than the cell asks for), without the program in the
checkout, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script: import the benchmark as the package ``bench`` from the
# checkout's root, not its modules from this directory
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))
# the allocator maps more of a segment where a block does not fit, rather
# than freeing its cache and retrying (a stall that moves from run to run
# at the round's 57-68 GB); a caller's own setting is kept
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    args = parse(argv)
    from bench import harness, spec
    cell = spec.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, log=log)
    # after set-up: nvidia-smi takes a second or more
    log(f"card: {harness.power_limit()}")
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def bytecode_cache():
    """Python's compiled modules in a fixed directory inside the checkout:
    where the environment sets ``PYTHONDONTWRITEBYTECODE`` and the
    installed packages carry no ``__pycache__``, every process would
    compile torch's sources anew (import and the first ``torch.func``
    call, which imports ``torch._dynamo``), seconds of a run's set-up that
    vary with the host; so only a checkout's first run compiles them."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


if __name__ == "__main__":
    bytecode_cache()
    sys.exit(main())
