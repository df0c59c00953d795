"""The port's MoE layer (``repro_torch.models.moe``) and PD-SGDM on the
Mixtral smoke config against the reference, from the same numpy inputs
and the reference's own params (``moe_init``, or the model's ``init``
through ``params_from_reference``).

Every draw is continuous, so no two router logits tie and ``torch.topk``
picks the experts ``lax.top_k`` picks (the two break ties differently).
The routing is integer work on the same gates: the top-k ids, the sorted
slot order, the kept mask and the drop count are held exactly.  The
values are f32 matmuls summed in other orders by XLA:CPU and PyTorch:

* outputs and the aux loss: atol 1e-5, rtol 1e-5 (measured: at most
  6.0e-7 apart), as ``tests/test_torch_models.py`` holds the layers;
* against the dense weighted sum over the top-k experts, computed here in
  f64: atol 1e-5 (the reference's own test holds itself at 1e-4);
* gradients: each leaf within 1e-5 of the largest gradient's max norm
  (measured: 2.0e-7 of it at most);
* PD-SGDM's kernel round, round by round from the same start: params
  and m within atol 2e-6 (measured: 1.2e-7 at most), losses rtol 1e-6
  (measured: 1.4e-7), as ``tests/test_torch_lm.py`` holds the tiny LM.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as r_smoke  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.data.synthetic import LMStreamCfg as RLMCfg  # noqa: E402
from repro.data.synthetic import lm_batch as r_lm_batch  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import DenseComm, make_optimizer, ring  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_FRAC = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small tensor ops (the
    suite runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    base = dict(d_model=16, d_ff=32, n_experts=4, top_k=2)
    base.update(kw)
    return r_moe.MoECfg(**base), moe.MoECfg(**base)


def _params(rcfg, seed=0):
    return jax.tree_util.tree_map(
        np.array, r_moe.moe_init(jax.random.PRNGKey(seed), rcfg,
                                 jnp.float32))


def _t(tree):
    return ({k: _t(v) for k, v in tree.items()} if isinstance(tree, dict)
            else torch.from_numpy(np.array(tree)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _dense_sum(p, xf, k):
    """The dense reference in f64: every expert on every token, the
    top-k outputs weighted by the renormalised gates."""
    p = {n: torch.from_numpy(np.array(v, np.float64))
         for n, v in (("w", p["router"]["w"]), ("wi", p["wi"]),
                      ("wg", p["wg"]), ("wo", p["wo"]))}
    x = torch.from_numpy(np.array(xf, np.float64))
    gates = torch.softmax(x @ p["w"], -1)
    top_w, top_e = torch.topk(gates, k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    outs = torch.stack([(torch.nn.functional.silu(x @ p["wg"][e])
                         * (x @ p["wi"][e])) @ p["wo"][e]
                        for e in range(p["wi"].shape[0])], 1)   # (N, E, d)
    picked = torch.gather(outs, 1, top_e[..., None].expand(-1, -1,
                                                           x.shape[1]))
    return (top_w[..., None] * picked).sum(1)


# ---------------------------------------------------------------- the layer
def test_moe_apply_at_high_capacity_matches_reference_and_dense_sum():
    rcfg, cfg = _cfgs(capacity_factor=8.0)
    p = _params(rcfg)
    x = _x((2, 8, 16))
    ry, raux = r_moe.moe_apply(p, x, rcfg)
    y, aux = moe.moe_apply(_t(p), torch.from_numpy(x), cfg)
    _close(y, ry)
    _close(aux, raux)
    assert 0.0 < float(aux) < 1.0
    _close(y.reshape(-1, 16), _dense_sum(p, x.reshape(-1, 16), 2).numpy())


@pytest.mark.parametrize("top_k,groups", [(2, 1), (1, 1), (2, 4)])
def test_moe_drops_the_reference_slots(top_k, groups):
    """At capacity factor 0.5 about half the slots overflow: the kept
    mask, the drop count, the slot order and the buffer equal the
    reference's, and so (within the bar) the output and the aux loss."""
    rcfg, cfg = _cfgs(top_k=top_k, capacity_factor=0.5, n_groups=groups)
    p = _params(rcfg)
    x = _x((1, 64, 16), seed=2)
    ry, raux = r_moe.moe_apply(p, x, rcfg)
    y, aux = moe.moe_apply(_t(p), torch.from_numpy(x), cfg)
    _close(y, ry)
    _close(aux, raux)
    # the dispatch of one group, on the same gates
    n = 64 // groups
    xf = x.reshape(groups, n, 16)[0]
    gates = np.asarray(jax.nn.softmax(xf @ p["router"]["w"], -1))
    C = r_moe._capacity(n, rcfg)
    assert moe.capacity(n, cfg) == C
    rbuf, (r_e, r_rank, r_tok, r_w, r_keep) = r_moe._dispatch(
        xf, gates, C, rcfg)
    top_w, top_e = torch.topk(torch.from_numpy(np.array(gates)), top_k)
    buf, (e, rank, tok, w, keep) = moe.dispatch(
        torch.from_numpy(xf)[None], top_w[None], top_e[None], C, cfg)
    keep = keep[0].numpy()
    dropped = int((~keep).sum())
    assert dropped == int((~np.asarray(r_keep)).sum()) > 0
    np.testing.assert_array_equal(keep, np.asarray(r_keep))
    np.testing.assert_array_equal(e[0].numpy(), np.asarray(r_e))
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(r_tok))
    np.testing.assert_array_equal(np.where(keep, rank[0].numpy(), C),
                                  np.asarray(r_rank))
    np.testing.assert_array_equal(buf[0].numpy(), np.asarray(rbuf))
    _close(w[0], r_w)


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_dispatch_equals_global_sort(groups):
    """At capacity ≥ all tokens no group drops: G groups equal the global
    sort, and the reference's grouped run."""
    rcfg1, cfg1 = _cfgs(capacity_factor=16.0)
    rcfgg, cfgg = _cfgs(capacity_factor=16.0, n_groups=groups)
    p = _params(rcfg1)
    x = torch.from_numpy(_x((2, 8, 16)))
    y1, a1 = moe.moe_apply(_t(p), x, cfg1)
    yg, ag = moe.moe_apply(_t(p), x, cfgg)
    _close(yg, y1.detach().numpy())
    assert float(ag) == float(a1)
    ry, _ = r_moe.moe_apply(p, x.numpy(), rcfgg)
    _close(yg, ry)


def test_grouped_fallback_when_indivisible():
    """N = 10 tokens in 7 groups: one global sort, bit for bit."""
    rcfg, cfg = _cfgs(d_model=8, d_ff=16, n_experts=2, top_k=1, n_groups=7)
    _, cfg1 = _cfgs(d_model=8, d_ff=16, n_experts=2, top_k=1)
    p = _params(rcfg)
    x = torch.from_numpy(_x((1, 10, 8), seed=3))
    y, aux = moe.moe_apply(_t(p), x, cfg)
    y1, aux1 = moe.moe_apply(_t(p), x, cfg1)
    assert torch.equal(y, y1) and torch.equal(aux, aux1)
    ry, raux = r_moe.moe_apply(p, x.numpy(), rcfg)
    _close(y, ry)
    _close(aux, raux)


@pytest.mark.parametrize("gated", [True, False])
def test_aux_loss_and_ungated_experts(gated):
    """The Switch aux loss w · E · Σ P_e f_e, by hand and against the
    reference, on gated SiLU and on GELU's tanh form."""
    rcfg, cfg = _cfgs(gated=gated, router_aux_weight=0.05)
    p = _params(rcfg, seed=4)
    x = _x((2, 12, 16), seed=5)
    ry, raux = r_moe.moe_apply(p, x, rcfg)
    y, aux = moe.moe_apply(_t(p), torch.from_numpy(x), cfg)
    _close(y, ry)
    _close(aux, raux)
    gates = torch.softmax(torch.from_numpy(x.reshape(-1, 16))
                          @ torch.from_numpy(p["router"]["w"]), -1)
    top_e = torch.topk(gates, 2).indices
    f_e = torch.stack([(top_e == e).any(-1).float().mean()
                       for e in range(4)]) / 2
    _close(aux, float(0.05 * 4 * (gates.mean(0) * f_e).sum()))


def test_grads_under_vmap_match_reference_per_worker():
    """Every MoE leaf's gradient of ``Σ y·r + aux`` for K = 2 stacked
    workers through ``torch.func.vmap(grad)``, at capacity factor 1.25
    (slots drop), against the reference's per worker."""
    rcfg, cfg = _cfgs()
    ps = [_params(rcfg, seed=s) for s in (6, 7)]
    xs = [_x((2, 16, 16), seed=s) for s in (8, 9)]
    r = _x((2, 16, 16), seed=10)

    def rloss(p, x):
        y, aux = r_moe.moe_apply(p, x, rcfg)
        return jnp.sum(y * r) + aux

    def loss(p, x):
        y, aux = moe.moe_apply(p, x, cfg)
        return torch.sum(y * torch.from_numpy(r)) + aux

    stacked = jax.tree_util.tree_map(lambda a, b: np.stack([a, b]), *ps)
    grads = torch.func.vmap(torch.func.grad(loss))(
        _t(stacked), torch.from_numpy(np.stack(xs)))
    for w in range(2):
        want = params_from_reference(jax.tree_util.tree_map(
            np.array, jax.grad(rloss)(ps[w], xs[w])), "cpu")
        got = params_from_reference(jax.tree_util.tree_map(
            lambda t: t[w].numpy(), grads), "cpu")
        assert list(got) == list(want) == ["router.w", "wg", "wi", "wo"]
        scale = max(float(v.abs().max()) for v in want.values())
        for k in want:
            _close(got[k], want[k].numpy(), atol=GRAD_FRAC * scale, rtol=0)


# ----------------------------------------------- PD-SGDM on the Mixtral smoke
K, P, ROUNDS = 2, 4, 2
HYPER = dict(eta=0.25, mu=0.9, p=P, weight_decay=1e-4)


def test_pd_sgdm_kernel_round_on_mixtral_smoke_matches_reference():
    """PD-SGDM on the Mixtral smoke config (2 layers of (attn, moe), 4
    experts top-2), K = 2 on ``ring(2)``, the chip path's step: each of two
    kernel rounds from the port's state after the rounds before it, against
    the reference's kernel round (its Pallas kernels in interpret mode on
    the CPU) from that same state.  The momentum launches write in place,
    so the round's input params and state must come back untouched."""
    mcfg = r_smoke("mixtral-8x7b").model
    rmodel = r_make_model(mcfg)
    p0 = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda _: rmodel.init(jax.random.PRNGKey(0)))(jnp.arange(K)))
    data = RLMCfg(vocab=mcfg.vocab, seq_len=16, batch=2, n_workers=K)
    batches = [jax.tree_util.tree_map(np.asarray, r_lm_batch(data, t))
               for t in range(ROUNDS * P)]
    ref = r_make_optimizer("pd_sgdm", RDenseComm(r_top.ring(K)),
                           use_kernel=True, **HYPER)
    rgrad = jax.vmap(jax.value_and_grad(lambda p, b: rmodel.loss(p, b)[0]))

    def r_grads(p, b):
        losses, g = rgrad(p, b)
        return losses.mean(), g

    r_round = jax.jit(lambda s, p, b: ref.round(s, p, r_grads, b))

    model = make_model(get_smoke_config("mixtral-8x7b").model)
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=True, **HYPER)
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: model.loss(p, b)[0]))

    def grads(p, b):
        g, losses = grad(p, b)
        return losses.mean(), g

    def nested(flat):
        out: dict = {}
        for name, v in flat.items():
            *path, leaf = name.split(".")
            d = out
            for q in path:
                d = d.setdefault(q, {})
            d[leaf] = np.array(v)
        return out

    def flat(tree):
        return params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                            tree), "cpu")

    params = flat(p0)
    state = opt.init(params)
    for r in range(ROUNDS):
        steps = batches[r * P:(r + 1) * P]
        stacked = {k: np.stack([b[k] for b in steps]) for k in steps[0]}
        rstate = {"m": nested(state["m"]),
                  "step": jnp.asarray(int(state["step"]), jnp.int32)}
        rp, rs, rl = r_round(rstate, nested(params), stacked)
        before = ({k: v.clone() for k, v in params.items()},
                  {k: v.clone() for k, v in state["m"].items()})
        new_p, new_s, losses = opt.round(
            state, params, grads,
            {k: torch.from_numpy(v) for k, v in stacked.items()})
        assert all(torch.equal(params[k], before[0][k]) for k in params)
        assert all(torch.equal(state["m"][k], before[1][k])
                   for k in state["m"])
        np.testing.assert_allclose(losses.numpy(), np.asarray(rl),
                                   rtol=1e-6)
        want_p, want_m = flat(rp), flat(rs["m"])
        for k in want_p:
            _close(new_p[k], want_p[k].numpy(), atol=2e-6, rtol=0)
            _close(new_s["m"][k], want_m[k].numpy(), atol=2e-6, rtol=0)
        assert int(new_s["step"]) == (r + 1) * P
        params, state = new_p, new_s
