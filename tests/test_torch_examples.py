"""The port-side examples (``examples/torch_*.py``) run on the CPU at a
trimmed step count, as CI runs the reference's with ``ABLATION_STEPS=8``:
every row's losses are finite and its comm-MB equal the reference's
formula, the bytes per round that the reference's optimizer of the same
configuration charges (kernel layout on both sides), through the rounds
run."""
import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelCfg as RModelCfg  # noqa: E402
from repro.core import (CPDSGDM, PDSGDM, CPDSGDMConfig,  # noqa: E402
                        IdentityCompressor, PDSGDMConfig, QSGDCompressor,
                        RandKCompressor, SignCompressor, TopKCompressor,
                        make_optimizer)
from repro.core.gossip import DenseComm  # noqa: E402
from repro.core.topology import (exponential,  # noqa: E402
                                 one_peer_exponential_schedule, ring)
from repro.models import make_model  # noqa: E402
from repro.models.resnet import resnet20_init  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, K = 8, 8
TINY = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small tensor ops: the
    suite runs several test processes at once, and a thread pool per
    process on the shared cores makes every small op wait at its barrier
    (under the parallel run this file took 20x its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(["--device", "cpu", "--steps", str(STEPS)])


def _want_mb(opt, one_worker):
    """MB through the rounds of a ``STEPS``-step run, round r charged
    ``cycle[r % T]``."""
    cycle = opt.bytes_per_round_cycle(one_worker)
    rounds = STEPS // opt.config.p
    return sum(cycle[r % len(cycle)] for r in range(rounds)) / 2 ** 20


def _tiny_params(name="tiny-lm"):
    return make_model(RModelCfg(name=name, **TINY)).init(
        jax.random.PRNGKey(0))


def _check(rows, refs, one_worker):
    assert len(rows) == len(refs)
    for row, ref in zip(rows, refs):
        assert len(row["loss"]) >= 2
        assert all(math.isfinite(v) for v in row["loss"]), row
        assert row["comm_mb"] == _want_mb(ref, one_worker), row


def test_torch_quickstart():
    rows = _run("torch_quickstart")
    refs = [PDSGDM(PDSGDMConfig(eta=0.3, mu=0.9, p=4, use_kernel=True),
                   DenseComm(ring(K))),
            CPDSGDM(CPDSGDMConfig(eta=0.3, mu=0.9, p=4, gamma=0.4,
                                  use_kernel=True),
                    DenseComm(ring(K)), SignCompressor()),
            PDSGDM(PDSGDMConfig(eta=0.3, mu=0.9, p=4, use_kernel=True),
                   DenseComm(one_peer_exponential_schedule(K)))]
    _check(rows, refs, _tiny_params())
    # the kernel wire of 107 rows, the sign wire, one neighbour's tree
    assert [r["comm_mb"] for r in rows] == [
        2 * 876_544 / 2 ** 20, 2 * 28_248 / 2 ** 20, 2 * 427_264 / 2 ** 20]


def test_torch_compression_ablation():
    rows = _run("torch_compression_ablation")
    grid = [(IdentityCompressor(), 0.4), (SignCompressor(), 0.4),
            (QSGDCompressor(levels=7), 0.4),
            (TopKCompressor(fraction=0.1), 0.15),
            (RandKCompressor(fraction=0.1), 0.1)]
    refs = [CPDSGDM(CPDSGDMConfig(eta=0.3, mu=0.9, p=4, gamma=gamma,
                                  use_kernel=True), DenseComm(topo), comp)
            for comp, gamma in grid for topo in (ring(K), exponential(K))]
    assert [(r["compressor"], r["topology"], r["gamma"]) for r in rows] == \
        [(c.name, t, g) for c, g in grid for t in ("ring", "exponential")]
    _check(rows, refs, _tiny_params("t"))


def test_torch_noniid_ablation():
    rows = _run("torch_noniid_ablation")
    eta = {"pd_sgdm": 0.1, "mt_dsgdm": 0.05}
    grid = [(alpha, name, p) for alpha in (None, 0.1)
            for name, ps in (("pd_sgdm", (1, 4)), ("mt_dsgdm", (2,)))
            for p in ps]
    assert [(r["alpha"], r["optimizer"], r["p"]) for r in rows] == grid
    refs = [make_optimizer(name, DenseComm(ring(K)), eta=eta[name], mu=0.9,
                           p=p, weight_decay=1e-4, use_kernel=True)
            for _, name, p in grid]
    _check(rows, refs, jax.tree_util.tree_map(
        np.asarray, resnet20_init(jax.random.PRNGKey(0), width=4)))


BENCH_PRETRAIN = os.path.join(ROOT, "benchmarks", "BENCH_pretrain.json")
PRETRAIN_RUNS = {"flat": [],
                 "hier": ["--node-size", "2", "--wire-dtype", "bfloat16"]}


@pytest.fixture(scope="module")
def pretrain_records(tmp_path_factory):
    """``examples/torch_pretrain_decentralized.py --quick``, 4 workers of
    2 ranks (its default model axis), in eight gloo ranks on the CPU, flat
    and on the sweep's hier row
    (``benchmarks/pretrain_sweep.py:126``), each run's JSON record."""
    import json
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = {}
    for tag, extra in PRETRAIN_RUNS.items():
        path = str(tmp_path_factory.mktemp("pretrain") / "run.json")
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "torch_pretrain_decentralized.py"),
             "--quick", "--workers", "4", "--device", "cpu", "--steps",
             str(STEPS), "--json-out", path] + extra,
            env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stdout + r.stderr
        with open(path) as f:
            out[tag] = json.load(f)
    return out


@pytest.mark.parametrize("tag", list(PRETRAIN_RUNS))
def test_torch_pretrain_decentralized(pretrain_records, tag):
    """The bytes per round and comm-MB of the committed
    ``BENCH_pretrain.json``'s ``train_flat``/``train_hier`` rows, exactly
    (16,262,144 and 2,032,768 B: the ring's two f32 neighbours of the
    2,032,768-param lm-5m, and the bf16 inter wire of hierarchical(2, 2)
    shipped by the leaders, over the node) and each rank's share under
    the model axis of 2; finite losses over 8 steps."""
    import json
    rec = pretrain_records[tag]
    with open(BENCH_PRETRAIN) as f:
        rows = {r["name"]: r["derived"] for r in json.load(f)["rows"]}
    want = rows[f"pretrain/train_{tag}"]
    assert rec["bytes_per_comm_round"] == want["bytes_per_comm_round"]
    assert rec["bytes_per_comm_round"] == {"flat": 16_262_144,
                                           "hier": 2_032_768}[tag]
    assert round(rec["comm_mb"], 4) == want["comm_mb"]
    assert (rec["model"], rec["workers"], rec["steps"]) == (
        want["model"], want["workers"], want["steps"])
    # the example's default model axis of 2 (the reference's mesh): each
    # of the 8 ranks ships its own shards, and a worker's two ranks each
    # ship the 9 × 128 replicated RMSNorm scales (9,216 B more a worker on
    # the ring's two f32 neighbours, 1,152 on the amortized bf16 inter)
    assert rec["model_axis"] == 2
    assert rec["bytes_per_rank"] == [{"flat": 8_135_680,
                                      "hier": 1_016_960}[tag]] * 8
    assert math.isfinite(rec["first_loss"]) and math.isfinite(
        rec["final_loss"])
    assert rec["final_loss"] < rec["first_loss"]


def test_torch_pretrain_claim_equal_loss(pretrain_records):
    """``claim_equal_loss`` as ``benchmarks/pretrain_sweep.py:145`` states
    it: the hier run's final loss within 5 % of the flat run's, at 8× less
    comm."""
    flat, hier = pretrain_records["flat"], pretrain_records["hier"]
    assert hier["final_loss"] <= 1.05 * flat["final_loss"]
    assert flat["comm_mb"] / hier["comm_mb"] == 8.0


def test_launcher_cpd_sign_bytes():
    """``repro_torch.launch.train --optimizer cpd_sgdm --compressor sign``
    in four gloo ranks on the CPU, the kernel layout, 8 steps (two rounds
    of p = 4): finite losses, and the comm-MB of the reference's
    ``bytes_per_round_cycle`` for the same model (the sign wire of the
    smoke OLMo's every leaf, to both ring neighbours)."""
    from repro.configs.registry import get_smoke_config as r_smoke
    from repro.core import SignCompressor as RSign
    from repro_torch.launch.train import main
    out = main(["--arch", "olmo-1b", "--smoke", "--optimizer", "cpd_sgdm",
                "--compressor", "sign", "--use-kernel", "--workers", "4",
                "--dist-backend", "gloo", "--device", "cpu", "--steps",
                str(STEPS)])
    run = r_smoke("olmo-1b")
    one = make_model(run.model).init(jax.random.PRNGKey(0))
    ref = make_optimizer("cpd_sgdm", DenseComm(ring(4)), p=run.optim.p,
                         compressor=RSign(block=1024), use_kernel=True)
    cycle = ref.bytes_per_round_cycle(one)
    assert out["steps"][-1] == STEPS - 1
    assert all(math.isfinite(v) for v in out["loss"])
    assert out["comm_mb"][-1] == (STEPS // run.optim.p) * cycle[0] / 2 ** 20


def test_launcher_profile_b_runs_and_resumes(tmp_path):
    """``repro_torch.launch.train --arch mixtral-8x7b --smoke --workers 2
    --data-axis 2``: Mixtral's own profile B, 2 pods × an FSDP axis of 2
    (4 gloo ranks on the CPU), 4 steps (one round of p = 4) with
    ``--ckpt-every 2``; a ``--resume`` to step 8 starts at step 4 and
    ends where an unbroken 8-step run ends; the comm-MB are the
    reference's for the whole worker."""
    from repro.configs.registry import get_smoke_config as r_smoke
    from repro_torch.launch.train import main
    base = ["--arch", "mixtral-8x7b", "--smoke", "--workers", "2",
            "--data-axis", "2", "--dist-backend", "gloo", "--device", "cpu"]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = main(base + ck + ["--steps", "4"])
    assert first["steps"][-1] == 3 and first["steps_run"] == 4
    assert all(math.isfinite(v) for v in first["loss"])
    assert os.listdir(tmp_path) == ["step_00000004"]
    resumed = main(base + ck + ["--steps", "8", "--resume"])
    assert resumed["steps_run"] == 4 and resumed["steps"][0] == 4
    unbroken = main(base + ["--steps", "8"])
    assert resumed["loss"][-1] == unbroken["loss"][-1]
    assert resumed["comm_mb"][-1] == unbroken["comm_mb"][-1]
    run = r_smoke("mixtral-8x7b")
    one = make_model(run.model).init(jax.random.PRNGKey(0))
    ref = make_optimizer(run.optim.name, DenseComm(ring(2)), p=run.optim.p)
    assert unbroken["comm_mb"][-1] == (
        8 // run.optim.p) * ref.bytes_per_round_cycle(one)[0] / 2 ** 20
