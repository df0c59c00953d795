"""The in-place form of the fused momentum update, on the CPU.

``momentum_update(..., inplace=True)`` writes x' and m' over x and m (on
the card through the C entry ``momentum_update_leaves_f32``; its
card-only counterpart is in ``tests/test_torch_cuda.py``).  PD-SGDM's
kernel round launches it on matrices that belong to the round, so every
optimizer that reaches PD's ``local_step_mat`` (PD, C-SGDM, CPD) must
return bit for bit what the out-of-place form returned, and leave the
caller's params and state untouched; QG-DSGDm discards m' and MT-DSGDm
runs its own update, so both keep the out-of-place launch and their
input matrices.  Everything here is exact: the two forms run the same
plain arithmetic.

PD's round hands the in-place launch its gradient as ``ops.Leaves`` and
the launch reads each leaf where it lies through a ``LeafTable`` (no
gradient matrix; on the CPU the table's plain version,
``ref.leaf_matrix_ref``, the g the kernel reads).  The table's geometry
is held here, and whole rounds on the leaf route bit for bit against the
same rounds with the gradient handed over flattened (:func:`_flatten_route`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DenseComm, SignCompressor,  # noqa: E402
                              make_optimizer, ring)
from repro_torch.core import complete  # noqa: E402
from repro_torch.kernels import LANE  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.momentum import (MAX_LEAVES,  # noqa: E402
                                          LeafTable, leaf_table,
                                          momentum_update)
from repro_torch.kernels.ref import leaf_matrix_ref  # noqa: E402

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


def _geometry_tree(case):
    """Leaves that end mid-row (37, 5 × 300 and 40 × 60 elements a worker)
    and fill whole rows (2 × 1,024); ``c`` handed over transposed."""
    rng = np.random.default_rng(7)
    lead = () if case == "no_worker_dim" else (3,)
    tree = {n: torch.from_numpy(rng.standard_normal(lead + shape,
                                                    dtype=np.float32))
            for n, shape in (("a", (37,)), ("b", (5, 300)), ("c", (60, 40)),
                             ("d", (2, LANE)))}
    tree["c"] = tree["c"].transpose(-1, -2)
    return tree


@pytest.mark.parametrize("case", ["worker_dim", "no_worker_dim",
                                  "alignment_tail"])
def test_leaf_table_geometry(case):
    """``KernelPlan.leaf_table``: each leaf from its slot's first row
    (row to leaf), its worker slices a stride apart, its last row partly
    valid (lanes past its size read 0), the rows past ``used_rows`` 0;
    a leaf the kernel cannot read in place (37 elements a worker, not a
    multiple of 4; or not contiguous) copied first, zero-padded to a
    multiple of 4.  The g the kernel reads through the table is the
    flatten's matrix, and the in-place update on it equals the update on
    the flattened matrix bit for bit."""
    tree = _geometry_tree(case)
    plan = kops.KernelPlan.for_tree(
        tree, worker_dim=case != "no_worker_dim",
        block_rows=16 if case == "alignment_tail" else 1)
    k = 1 if case == "no_worker_dim" else 3
    table = plan.leaf_table(tree)
    assert table.row_starts == (0, 1, 3, 6)
    assert plan.used_rows == 8
    assert plan.rows == (16 if case == "alignment_tail" else 8)
    assert (table.workers, table.rows) == (k, plan.rows)
    assert table.sizes == (40, 1500, 2400, 2 * LANE)
    assert table.strides == table.sizes and table.copies == 2
    assert table.leaves[1] is tree["b"] and table.leaves[3] is tree["d"]
    g = leaf_matrix_ref(table)
    flat = plan.flatten(tree).reshape(k, plan.rows, LANE)
    assert torch.equal(g, flat)
    assert torch.equal(g[:, 0, 37:], torch.zeros(k, LANE - 37))
    assert torch.equal(g[:, 2, 1500 - LANE:], torch.zeros(k, 2 * LANE - 1500))
    assert not g[:, plan.used_rows:].any()
    assert torch.equal(g[:, 1:3].reshape(k, -1)[:, :1500],
                       tree["b"].reshape(k, -1))
    x, m = _mats(8, k * plan.rows, n=2)
    lr = torch.tensor(0.05)
    want = momentum_update(x, m, flat.view(-1, LANE), lr, mu=0.9, wd=1e-4,
                           nesterov=True)
    got = momentum_update(x, m, table, lr, mu=0.9, wd=1e-4, nesterov=True,
                          inplace=True)
    assert got[0] is x and got[1] is m
    assert torch.equal(x, want[0]) and torch.equal(m, want[1])


def test_leaf_table_rows_before_the_first_leaf_and_refusals():
    """A table that starts past row 0 reads 0 there, and a later leaf
    takes over from its first row; a table is read in place only, and
    must cover x's rows."""
    leaves = [torch.arange(2 * 3000, dtype=torch.float32).reshape(2, 3000),
              -torch.ones((2, 8))]
    table = leaf_table(leaves, (5, 7), workers=2, rows=9)
    assert isinstance(table, LeafTable) and table.copies == 0
    g = leaf_matrix_ref(table)
    assert not g[:, :5].any() and not g[:, 8:].any()
    assert torch.equal(g[:, 5:7].reshape(2, -1), leaves[0][:, :2 * LANE])
    assert torch.equal(g[:, 7, :8], -torch.ones((2, 8)))
    assert not g[:, 7, 8:].any()
    x, m = _mats(9, 18, n=2)
    lr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="in-place launch only"):
        momentum_update(x, m, table, lr, mu=0.9)
    with pytest.raises(ValueError, match="rows"):
        momentum_update(x[:16], m[:16], table, lr, mu=0.9, inplace=True)


@pytest.mark.parametrize("n_leaves", [MAX_LEAVES, MAX_LEAVES + 1])
def test_leaves_past_one_table_are_flattened(n_leaves, monkeypatch):
    """One launch's table holds ``MAX_LEAVES`` leaves: a tree of that many
    is read through it, a tree of one more is flattened first, and
    ``momentum_update`` refuses such a table.  Either way the update is
    the one on the flattened matrix, bit for bit (ragged leaves of 3 to
    2,999 elements a worker, K = 3)."""
    rng = np.random.default_rng(n_leaves)
    tree = {f"l{j:03d}": torch.from_numpy(rng.standard_normal(
        (3, int(s)), dtype=np.float32))
        for j, s in enumerate(rng.integers(3, 3000, size=n_leaves))}
    plan = kops.KernelPlan.for_tree(tree, worker_dim=True)
    tables = []
    table = kops.KernelPlan.leaf_table
    monkeypatch.setattr(kops.KernelPlan, "leaf_table",
                        lambda p, t: tables.append(p) or table(p, t))
    x, m = _mats(plan.rows, 3 * plan.rows, n=2)
    lr = torch.tensor(0.05)
    want = momentum_update(x, m, plan.flatten(tree).view(-1, LANE), lr,
                           mu=0.9, wd=1e-4)
    xs, ms = x.view(3, plan.rows, LANE), m.view(3, plan.rows, LANE)
    kops.momentum_update_mat(xs, ms, kops.Leaves(plan, tree), mu=0.9, lr=lr,
                             weight_decay=1e-4, inplace=True)
    assert len(tables) == (n_leaves <= MAX_LEAVES)
    assert torch.equal(x, want[0]) and torch.equal(m, want[1])
    if n_leaves > MAX_LEAVES:
        with pytest.raises(ValueError, match="more than one launch holds"):
            momentum_update(x, m, table(plan, tree), lr, mu=0.9,
                            inplace=True)


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


def _flatten_route(opt):
    """``opt``'s local step handed the gradient flattened into a matrix
    (the hand-off before the leaf table), instead of ``ops.Leaves``."""
    step = opt.local_step_mat
    opt.local_step_mat = lambda x, mats, g, s: step(x, mats,
                                                    kops.as_matrix(g), s)


@pytest.mark.parametrize("route", ["flatten", "leaves"])
@pytest.mark.parametrize("name", ["pd_sgdm", "pd_sgdm_overlap", "cpd_sgdm",
                                  "c_sgdm"])
def test_kernel_rounds_equal_the_out_of_place_rounds(name, route,
                                                     monkeypatch):
    """Three rounds and a 2-step tail with the in-place launch equal, bit
    for bit, the same rounds with the out-of-place launch (the port before
    the in-place form); each round leaves its input params and state as
    they were, and launches the update once a step.  ``leaves``: the
    in-place rounds read the gradient through a leaf table, once a step on
    PD and CPD (sign); C-SGDM mixes the flattened gradient, so it reads
    none; ``flatten``: every round is handed the gradient flattened."""
    calls, tables = [], []
    inner = kops.momentum_update
    table = kops.KernelPlan.leaf_table

    def counted(*args, **kwargs):
        calls.append(kwargs.get("inplace", False))
        return inner(*args, **kwargs)

    def counted_table(plan, tree):
        tables.append(id(tree))
        return table(plan, tree)

    monkeypatch.setattr(kops, "momentum_update", counted)
    monkeypatch.setattr(kops.KernelPlan, "leaf_table", counted_table)
    runs = {}
    for inplace in (True, False):
        if not inplace:
            mat = kops.momentum_update_mat
            monkeypatch.setattr(kops, "momentum_update_mat",
                                lambda *a, **kw: mat(*a, **dict(
                                    kw, inplace=False)))
        opt = _opt(name)
        if route == "flatten":
            _flatten_route(opt)
        params = _params()
        state = opt.init(params)
        for r in range(4):
            tail = r == 3
            batches = _batches(r, params)
            if tail:
                batches = {n: v[:2] for n, v in batches.items()}
            before = (_snapshot(params), _snapshot(state))
            del calls[:], tables[:]
            new_p, new_s, _ = opt.round(state, params, _grads_fn, batches,
                                        gossip=not tail)
            assert _equal(params, before[0]) and _equal(state, before[1])
            assert calls == [inplace] * len(batches["a"])
            read = route == "leaves" and inplace and name != "c_sgdm"
            assert len(tables) == (len(batches["a"]) if read else 0)
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
