"""PD-SGDM and CPD-SGDM on the quickstart's tiny LM in the port against
the reference: the LM stream, the kernel layout of the LM tree, the bytes
per round, and three rounds on the ring and on ``hierarchical(2, 4)``, on
the tree and on the kernel layout, from the reference's params on the
reference's ``lm_batch`` batches.

The transformer is smooth, so PD-SGDM's runs stay within a few ulps over
three rounds (measured: params 4.8e-7 apart, m 3.9e-8; bar atol 2e-6).
CPD-SGDM's sign wire flips where the drift ``x_new − x̂`` lies within an
ulp of zero, moving x̂ by 2·scale there; a flipped element then moves the
next round's consensus, so a run of three rounds parts by up to 5e-3 in
the params (measured).  CPD-SGDM is therefore held round by round from
the same start, as ``chip_smoke.py``'s ``round_parity_phase`` holds the
churn paths: params within atol 2e-6 (measured 2.4e-7), m within 2e-7
(measured 3.0e-8), x̂ within rtol 1e-3 / atol 1e-4 but for at most 4
elements, each moved by at most 2·max|x̂ − x̂_prev| (measured: 2 elements
in round 0, by 7.5e-3 against a drift of 3.3e-2).  Bytes are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelCfg as RModelCfg  # noqa: E402
from repro.core import SignCompressor as RSign  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.data.synthetic import LMStreamCfg as RLMCfg  # noqa: E402
from repro.data.synthetic import lm_batch as r_lm_batch  # noqa: E402
from repro.kernels.ops import KernelPlan as RPlan  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.configs.base import ModelCfg  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (DenseComm, SignCompressor,  # noqa: E402
                              make_optimizer)
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.data.synthetic import LMStreamCfg, lm_batch  # noqa: E402
from repro_torch.kernels.ops import KernelPlan  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.train.trainer import SimTrainer  # noqa: E402

K, P, STEPS = 8, 4, 12
TINY = dict(name="tiny-lm", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
HYPER = dict(eta=0.3, mu=0.9, p=P, gamma=0.4)     # the quickstart's
GRAPHS = {"ring": lambda t: t.ring(K), "hier": lambda t: t.hierarchical(2, 4)}
_CACHE: dict = {}


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


def _ref():
    """The reference's tiny LM, its K stacked params (every worker from
    the same x0, as the quickstart) and its first 12 batches, as numpy."""
    if "rmodel" not in _CACHE:
        rmodel = r_make_model(RModelCfg(**TINY))
        p0 = jax.vmap(lambda _: rmodel.init(jax.random.PRNGKey(0)))(
            jnp.arange(K))
        data = RLMCfg(vocab=256, seq_len=32, batch=4, n_workers=K)
        _CACHE.update(
            rmodel=rmodel,
            params=jax.tree_util.tree_map(np.asarray, p0),
            batches=[jax.tree_util.tree_map(np.asarray, r_lm_batch(data, t))
                     for t in range(STEPS)])
    return _CACHE["rmodel"], _CACHE["params"], _CACHE["batches"]


def _flat(tree):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree),
                                 "cpu")


def _nested(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = np.array(v)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_opt(name, graph, use_kernel):
    comp = SignCompressor() if name == "cpd_sgdm" else None
    return make_optimizer(name, DenseComm(GRAPHS[graph](top), device="cpu"),
                          compressor=comp, use_kernel=use_kernel, **HYPER)


def _ref_opt(name, graph, use_kernel=False):
    comp = RSign() if name == "cpd_sgdm" else None
    return r_make_optimizer(name, RDenseComm(GRAPHS[graph](r_top)),
                            compressor=comp, use_kernel=use_kernel, **HYPER)


# ---------------------------------------------------------------- LM stream
def test_lm_batch_shapes_determinism_and_shift():
    cfg = LMStreamCfg(vocab=256, seq_len=32, batch=4, n_workers=K)
    b = lm_batch(cfg, 3, device="cpu")
    assert sorted(b) == ["labels", "tokens"]
    for v in b.values():
        assert v.shape == (K, 4, 32) and v.dtype == torch.int32
        assert int(v.min()) >= 0 and int(v.max()) < 256
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    again = lm_batch(cfg, 3, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(lm_batch(cfg, 4, device="cpu")["tokens"],
                           b["tokens"])
    other_seed = lm_batch(dataclasses.replace(cfg, seed=1), 3, device="cpu")
    assert not torch.equal(other_seed["tokens"], b["tokens"])
    # a vocabulary below the cluster count clips at vocab − 1
    small = lm_batch(LMStreamCfg(vocab=10, seq_len=16, batch=8, n_workers=2),
                     0, device="cpu")["tokens"]
    assert int(small.max()) == 9 and int(small.min()) >= 0


def _chain_share(tokens, span, n_c):
    """Share of transitions whose cluster steps along the chain (+1)."""
    c = tokens // span
    return float(np.mean((c[..., 1:] - c[..., :-1]) % n_c == 1))


def test_lm_batch_plants_the_reference_structure():
    """The same planted structure as the reference's stream: the share of
    chain steps (both positions kept w.p. 0.8², plus chance) and the
    token range agree within sampling noise (3σ < 0.01 at this size)."""
    cfg = LMStreamCfg(vocab=1000, seq_len=64, batch=32, n_workers=8)
    ours = np.concatenate([lm_batch(cfg, t, device="cpu")["tokens"].numpy()
                           for t in range(4)])
    rcfg = RLMCfg(vocab=1000, seq_len=64, batch=32, n_workers=8)
    theirs = np.concatenate([np.asarray(r_lm_batch(rcfg, t)["tokens"])
                             for t in range(4)])
    span = 1000 // 64
    a, b = _chain_share(ours, span, 64), _chain_share(theirs, span, 64)
    assert abs(a - b) < 0.01 and 0.64 < a < 0.68
    assert ours.max() <= 999 and theirs.max() <= 999
    assert abs(ours.mean() - theirs.mean()) < 3.0


# -------------------------------------------------------- layout, bytes
def test_kernel_plan_of_the_tiny_lm_equals_reference():
    """The tiny LM's 12 leaves take 107 of 256 rows on both sides."""
    _, rparams, _ = _ref()
    one = jax.tree_util.tree_map(lambda x: x[0], rparams)
    ours = KernelPlan.for_tree(_flat(one))
    theirs = RPlan.for_tree(jax.tree_util.tree_map(jnp.asarray, one))
    assert (ours.rows, ours.used_rows, ours.n_valid) == \
        (theirs.rows, theirs.used_rows, theirs.n_valid) == (256, 107,
                                                            106_816)
    assert [(s.shape, s.size, s.row_start, s.n_rows) for s in ours.slots] \
        == [(s.shape, s.size, s.row_start, s.n_rows) for s in theirs.slots]
    assert len(ours.slots) == 12
    np.testing.assert_array_equal(ours.row_counts().numpy(),
                                  np.asarray(theirs.row_counts()))


@pytest.mark.parametrize("name,graph,use_kernel,want", [
    ("pd_sgdm", "ring", True, 876_544),      # 2 × 107 × 1024 × 4 B
    ("pd_sgdm", "ring", False, 854_528),     # 2 × 106,816 × 4 B
    ("pd_sgdm", "hier", True, 106_816),      # 1 × 106,816 × 4 B / 4
    ("pd_sgdm", "hier", False, 106_816),
    ("cpd_sgdm", "ring", True, 28_248),      # 2 × 107 × (128 + 4) B
    ("cpd_sgdm", "hier", True, 56_496),
])
def test_bytes_per_round_equal_reference(name, graph, use_kernel, want):
    _, rparams, _ = _ref()
    one = jax.tree_util.tree_map(lambda x: x[0], rparams)
    got = _port_opt(name, graph, use_kernel).bytes_per_round_cycle(
        _flat(one))
    theirs = _ref_opt(name, graph, use_kernel).bytes_per_round_cycle(one)
    assert got == theirs == (want,)


# ---------------------------------------------------------------- rounds
def _loss_fn():
    model = make_model(ModelCfg(**TINY))
    return lambda p, b: model.loss(p, b)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pd_sgdm_three_rounds_match_reference(graph):
    rmodel, rparams, batches = _ref()
    ref = _ref_opt("pd_sgdm", graph)
    rp, rs, rh = RSimTrainer(lambda p, b: rmodel.loss(p, b), ref).train(
        rparams, lambda t: batches[t], STEPS, log_every=1)
    want_p, want_m = _flat(rp), _flat(rs["m"])
    for use_kernel in (False, True):
        opt = _port_opt("pd_sgdm", graph, use_kernel)
        params, state, hist = SimTrainer(_loss_fn(), opt, device="cpu").train(
            _flat(rparams), lambda t: _t(batches[t]), STEPS, log_every=1)
        np.testing.assert_allclose(hist.loss, rh.loss, rtol=1e-6)
        assert hist.comm_mb[-1] == STEPS // P * opt.bytes_per_round_cycle(
            {k: v[0] for k, v in params.items()})[0] / 2 ** 20
        for k in want_p:
            np.testing.assert_allclose(params[k].numpy(), want_p[k].numpy(),
                                       atol=2e-6, rtol=0)
            np.testing.assert_allclose(state["m"][k].numpy(),
                                       want_m[k].numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_cpd_sgdm_sign_rounds_match_reference(graph, use_kernel):
    """Three rounds, each from the port's state after the rounds before
    it, against the reference's round from that same state."""
    rmodel, rparams, batches = _ref()
    if ("cpd_round", graph) not in _CACHE:     # one compile per graph
        ref = _ref_opt("cpd_sgdm", graph)
        rgrad = jax.vmap(jax.value_and_grad(
            lambda p, b: rmodel.loss(p, b)[0]))

        def r_grads(p, b):
            losses, g = rgrad(p, b)
            return losses.mean(), g

        _CACHE["cpd_round", graph] = jax.jit(
            lambda s, p, b: ref.round(s, p, r_grads, b))
    r_round = _CACHE["cpd_round", graph]
    opt = _port_opt("cpd_sgdm", graph, use_kernel)
    loss_fn = _loss_fn()
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: loss_fn(p, b)[0]))

    def grads(p, b):
        g, losses = grad(p, b)
        return losses.mean(), g

    params = _flat(rparams)
    state = opt.init(params)
    for r in range(STEPS // P):
        steps = batches[r * P:(r + 1) * P]
        stacked = {k: np.stack([b[k] for b in steps]) for k in steps[0]}
        rstate = {"m": _nested(state["m"]), "xhat": _nested(state["xhat"]),
                  "step": jnp.asarray(int(state["step"]), jnp.int32)}
        rp, rs, rl = r_round(rstate, _nested(params), stacked)
        new_p, new_s, losses = opt.round(state, params, grads, _t(stacked))
        np.testing.assert_allclose(losses.numpy(), np.asarray(rl),
                                   rtol=1e-6)
        want_p, want_m, want_x = (_flat(rp), _flat(rs["m"]),
                                  _flat(rs["xhat"]))
        drift = max(float((want_x[k] - state["xhat"][k]).abs().max())
                    for k in want_x)
        moved = 0
        for k in want_p:
            np.testing.assert_allclose(new_p[k].numpy(), want_p[k].numpy(),
                                       atol=2e-6, rtol=0)
            np.testing.assert_allclose(new_s["m"][k].numpy(),
                                       want_m[k].numpy(), atol=2e-7, rtol=0)
            gap = (new_s["xhat"][k] - want_x[k]).abs()
            far = ~torch.isclose(new_s["xhat"][k], want_x[k], rtol=1e-3,
                                 atol=1e-4)
            assert bool((gap[far] <= 2 * drift).all())
            moved += int(far.sum())
        assert moved <= 4
        assert int(new_s["step"]) == (r + 1) * P
        params, state = new_p, new_s


# ------------------------------------------- chip_smoke.py's six LM paths
def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", ["pd_sgdm_olmo1b", "pd_sgdm_mixtral",
                                  "pd_sgdm_minicpm3", "pd_sgdm_mamba2",
                                  "pd_sgdm_tinylm_hier",
                                  "cpd_sgdm_tinylm_sign"])
def test_chip_smoke_lm_paths_on_the_cpu(path, monkeypatch):
    """Each LM path of ``chip_smoke.py`` through the script's own
    ``make_opt`` and ``drive`` on the CPU (OLMo, Mixtral, MiniCPM3 and
    Mamba2 at their smoke widths, one layer, at the path's sequence and
    batch, Mamba2 at two chunks of its smoke SSD: launches do not depend
    on the widths): the kernel launches of its 14-step run, counted by
    the calls of the kernel wrappers, equal the script's ``EXPECTED``; the
    losses are finite; and at the path's real widths (one layer of each
    model, as cut in ``FULL_WIDTH``, as meta tensors, never allocated) its
    plan's rows and used rows equal ``FULL_WIDTH``'s and its bytes per
    round equal the script's ``WIRE_BYTES`` and the reference's on the
    same shapes, on the path's ring (K = 2 for Mixtral)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import ops as kops
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    counts = dict.fromkeys(cs.EXPECTED[path], 0)

    def counted(fn, key, n_of):
        def wrapper(*args, **kwargs):
            counts[key] += n_of(args, kwargs)
            return fn(*args, **kwargs)
        return wrapper

    one = lambda a, k: 1                                  # noqa: E731
    for name, key, n_of in (
            ("momentum_update", "momentum_update", one),
            ("gossip_mix", "gossip_mix",
             lambda a, k: gm.launch_count(len(a[0]))),
            ("gossip_mix_shifted", "gossip_mix",
             lambda a, k: gm.launch_count(len(k["shifts"])))):
        monkeypatch.setattr(kops, name, counted(getattr(kops, name), key,
                                                n_of))
    for key, mod in (("sign_pack", kops.sc), ("sign_unpack", kops.sc)):
        monkeypatch.setattr(mod, key, counted(getattr(mod, key), key, one))
    full = cs.lm_model(path)
    if path in cs.FULL_WIDTH:
        small = make_model(dataclasses.replace(
            get_smoke_config(full.cfg.name).model, n_layers=1))
        monkeypatch.setattr(cs, "lm_model", lambda _path: small)
    if path == "pd_sgdm_mamba2":
        # two chunks of the smoke SSD, as the path's seq is four of its
        # own: the chunk recurrence still runs, at a 32nd of the positions
        monkeypatch.setitem(cs.FULL_WIDTH[path], "seq",
                            2 * small.cfg.ssm_chunk)
    opt = cs.make_opt(path, use_kernel=True)
    _, params, state, hist = cs.drive(torch, opt, path, 0, cs.STEPS)
    assert {k: v for k, v in counts.items() if v} == cs.EXPECTED[path]
    assert len(hist.loss) == cs.STEPS and all(np.isfinite(hist.loss))
    assert int(state["step"]) == cs.STEPS
    shapes = full.param_shapes()
    meta = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    if path in cs.FULL_WIDTH:
        # the shape at which the full-width kernel phase holds the kernels
        plan = kops.KernelPlan.for_tree(
            {n: torch.empty((cs.WORKERS.get(path, K),) + s, device="meta")
             for n, s in shapes.items()}, worker_dim=True)
        assert (plan.rows, plan.used_rows) == (
            cs.FULL_WIDTH[path]["rows"], cs.FULL_WIDTH[path]["used"])
    ours = opt.bytes_per_round_cycle(meta)
    rtree: dict = {}
    for leaf_name, s in shapes.items():
        *p, leaf = leaf_name.split(".")
        d = rtree
        for q in p:
            d = d.setdefault(q, {})
        d[leaf] = jax.ShapeDtypeStruct(s, jnp.float32)
    name = "cpd_sgdm" if path.startswith("cpd") else "pd_sgdm"
    if path == "pd_sgdm_tinylm_hier":
        ref = _ref_opt(name, "hier", use_kernel=True)
    else:
        comp = RSign() if name == "cpd_sgdm" else None
        ref = r_make_optimizer(name, RDenseComm(r_top.ring(
            cs.WORKERS.get(path, K))), compressor=comp, use_kernel=True,
            **HYPER)
    theirs = ref.bytes_per_round_cycle(rtree)
    assert ours == theirs == cs.WIRE_BYTES[path]
