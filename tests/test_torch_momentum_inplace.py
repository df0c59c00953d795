"""The in-place form of the fused momentum update, on the CPU.

``momentum_update(..., inplace=True)`` writes x' and m' over x and m (on
the card through the C entry ``momentum_update_inplace_f32``; its
card-only counterpart is in ``tests/test_torch_cuda.py``).  PD-SGDM's
kernel round launches it on matrices that belong to the round, so every
optimizer that reaches PD's ``local_step_mat`` (PD, C-SGDM, CPD) must
return bit for bit what the out-of-place form returned, and leave the
caller's params and state untouched; QG-DSGDm discards m' and MT-DSGDm
runs its own update, so both keep the out-of-place launch and their
input matrices.  Everything here is exact: the two forms run the same
plain arithmetic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DenseComm, SignCompressor,  # noqa: E402
                              make_optimizer, ring)
from repro_torch.core import complete  # noqa: E402
from repro_torch.kernels import LANE  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402

K, P = 4, 4


def _mats(seed, rows, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((rows, LANE),
                                                 dtype=np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("nesterov", [False, True])
def test_inplace_equals_out_of_place_bit_for_bit(nesterov):
    x, m, g = _mats(0, 333)
    lr = torch.tensor(0.05)
    want = momentum_update(x, m, g, lr, mu=0.9, wd=1e-4, nesterov=nesterov)
    before = momentum_update.launches
    got = momentum_update(x, m, g, lr, mu=0.9, wd=1e-4, nesterov=nesterov,
                          inplace=True)
    assert got[0] is x and got[1] is m
    assert torch.equal(x, want[0]) and torch.equal(m, want[1])
    assert momentum_update.launches == before    # plain versions count none


def test_inplace_refuses_overlapping_operands():
    x, m, g = _mats(1, 16)
    lr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="overlap"):
        momentum_update(x, x, g, lr, mu=0.9, inplace=True)
    with pytest.raises(ValueError, match="overlap"):
        momentum_update(x, m, x, lr, mu=0.9, inplace=True)
    both = torch.cat([x, m])
    with pytest.raises(ValueError, match="overlap"):
        momentum_update(both[:16], both[8:24], g, lr, mu=0.9, inplace=True)


def test_momentum_update_mat_inplace_writes_the_matrices():
    x, m, g = (t.reshape(2, 256, LANE) for t in _mats(2, 512))
    lr = torch.tensor(0.25)
    want = kops.momentum_update_mat(x, m, g, mu=0.9, lr=lr,
                                    weight_decay=1e-4)
    got = kops.momentum_update_mat(x, m, g, mu=0.9, lr=lr,
                                   weight_decay=1e-4, inplace=True)
    assert got[0] is x and got[1] is m
    assert torch.equal(x, want[0]) and torch.equal(m, want[1])


# ---------------------------------------------------------------- the rounds
def _params(k=K):
    """Ragged leaves (tail rows partly padded) of K workers that differ."""
    rng = np.random.default_rng(3)
    return {"a": torch.from_numpy(rng.standard_normal((k, 37),
                                                      dtype=np.float32)),
            "b": torch.from_numpy(rng.standard_normal((k, 5, 300),
                                                      dtype=np.float32))}


def _grads_fn(params, batch):
    """A quadratic pulled to each step's target: fresh grad tensors."""
    grads = {n: v - batch[n] for n, v in params.items()}
    loss = sum((g * g).sum() for g in grads.values()) / 2
    return loss, grads


def _batches(r, params):
    rng = np.random.default_rng(100 + r)
    return {n: torch.from_numpy(rng.standard_normal(
        (P,) + tuple(v.shape), dtype=np.float32)) for n, v in params.items()}


def _opt(name):
    if name == "c_sgdm":
        return make_optimizer("c_sgdm", DenseComm(complete(K), device="cpu"),
                              eta=0.1, weight_decay=1e-4, use_kernel=True)
    kw = dict(eta=0.1, mu=0.9, p=P, weight_decay=1e-4, use_kernel=True)
    if name == "cpd_sgdm":
        kw.update(gamma=0.4, compressor=SignCompressor())
    overlap = name.endswith("_overlap")
    return make_optimizer(name.replace("_overlap", ""),
                          DenseComm(ring(K), device="cpu"), overlap=overlap,
                          **kw)


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.clone()


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("name", ["pd_sgdm", "pd_sgdm_overlap", "cpd_sgdm",
                                  "c_sgdm"])
def test_kernel_rounds_equal_the_out_of_place_rounds(name, monkeypatch):
    """Three rounds and a 2-step tail with the in-place launch equal, bit
    for bit, the same rounds with the out-of-place launch (the port before
    the in-place form); each round leaves its input params and state as
    they were, and launches the update once a step."""
    calls = []
    inner = kops.momentum_update

    def counted(*args, **kwargs):
        calls.append(kwargs.get("inplace", False))
        return inner(*args, **kwargs)

    monkeypatch.setattr(kops, "momentum_update", counted)
    runs = {}
    for inplace in (True, False):
        if not inplace:
            mat = kops.momentum_update_mat
            monkeypatch.setattr(kops, "momentum_update_mat",
                                lambda *a, **kw: mat(*a, **dict(
                                    kw, inplace=False)))
        opt = _opt(name)
        params = _params()
        state = opt.init(params)
        for r in range(4):
            tail = r == 3
            batches = _batches(r, params)
            if tail:
                batches = {n: v[:2] for n, v in batches.items()}
            before = (_snapshot(params), _snapshot(state))
            del calls[:]
            new_p, new_s, _ = opt.round(state, params, _grads_fn, batches,
                                        gossip=not tail)
            assert _equal(params, before[0]) and _equal(state, before[1])
            assert calls == [inplace] * len(batches["a"])
            params, state = new_p, new_s
        runs[inplace] = (params, state)
    assert _equal(runs[True][0], runs[False][0])
    assert _equal(runs[True][1], runs[False][1])


@pytest.mark.parametrize("name", ["qg_dsgdm", "mt_dsgdm"])
def test_tracking_steps_keep_their_input_matrices(name):
    """QG-DSGDm discards the launch's m' (m moves only at a gossip) and
    MT-DSGDm updates on its tracked direction: each local step on the
    kernel layout leaves x, m and the tracking matrices as they were."""
    opt = make_optimizer(name, DenseComm(ring(K), device="cpu"), eta=0.1,
                         mu=0.9, p=P, weight_decay=1e-4, use_kernel=True)
    params = _params()
    state = opt.init(params)
    plan = kops.KernelPlan.for_tree(params, worker_dim=True)
    x_mat = plan.flatten(params)
    mats = opt.mat_state(plan, state)
    mats["m"] = mats["m"] + 0.5          # a non-zero momentum
    g_mat = plan.flatten(_grads_fn(params, {n: v[0] for n, v in
                                            _batches(0, params).items()})[1])
    before = (x_mat.clone(), _snapshot(mats))
    x_new, new_mats = opt.local_step_mat(x_mat, mats, g_mat, state["step"])
    assert torch.equal(x_mat, before[0]) and _equal(mats, before[1])
    assert not torch.equal(x_new, x_mat)
    if name == "qg_dsgdm":
        assert new_mats["m"] is mats["m"]
