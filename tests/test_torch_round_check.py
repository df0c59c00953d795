"""The round-contract checks on executed rounds
(``repro_torch.analysis.round_check``): the reference's fast dense grid is
green at head, and each seeded violation is caught with its own message —
an extra exchange inside the steps, an ``.item()`` in ``grads_fn``, a
float64 op, a second flatten of the params, a step that hands its
gradient to the layout twice or not at all, and a live worker that reads a
dead worker's column.  The reference's own checks
(``tests/test_analysis_jaxpr.py``) are the counterpart; the fake process
group of the sharded case lives inside its ``fake_group`` block."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import round_check as rc  # noqa: E402
from repro_torch.analysis.run import fake_group, phase_dense  # noqa: E402
from repro_torch.core import (DenseComm, complete,  # noqa: E402
                              make_optimizer, ring)
from repro_torch.core import SignCompressor  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

K = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fast_dense_grid_green_at_head(capsys):
    assert phase_dense(False) == []
    out = capsys.readouterr().out
    assert out.count("  ok ") == 15 and "FAIL" not in out


def _opt(name="pd_sgdm", kernel=False, **kw):
    if name == "c_sgdm":     # p = 1 on the complete graph
        return make_optimizer(name, DenseComm(complete(K), device="cpu"),
                              eta=0.05, use_kernel=kernel, **kw)
    if name == "cpd_sgdm":
        kw.update(gamma=0.4, compressor=SignCompressor())
    return make_optimizer(name, DenseComm(ring(K), device="cpu"), eta=0.05,
                          mu=0.9, p=3, use_kernel=kernel, **kw)


def _flatten_route(opt):
    """``opt``'s local step handed the gradient flattened into a matrix
    (the hand-off before the leaf table), instead of ``ops.Leaves``."""
    step = opt.local_step_mat
    opt.local_step_mat = lambda x, mats, g, s: step(x, mats,
                                                    kops.as_matrix(g), s)


def _round(opt, grads_fn=rc.toy_grads_fn):
    params = rc.toy_params(K)
    state = opt.init(params)
    batches = rc.toy_batches(opt.config.p, K)
    return rc.trace_round(opt, params, state, batches, grads_fn=grads_fn)


@pytest.mark.parametrize("name,route,handoff", [
    ("pd_sgdm", "flatten", "flatten"),
    ("pd_sgdm", "leaves", "leaves"),
    ("cpd_sgdm", "leaves", "leaves"),
    # these mix or track the gradient as a matrix: still flattened
    ("c_sgdm", "leaves", "flatten"),
    ("mt_dsgdm", "leaves", "flatten"),
    ("qg_dsgdm", "leaves", "flatten"),
])
def test_clean_round_records_steps_and_flattens(name, route, handoff):
    """A clean kernel round hands each step's gradient to the layout
    once: read as leaves by PD's and CPD's in-place momentum launch, or
    flattened where it is handed over as a matrix; C-SGDM, MT and QG
    flatten theirs."""
    opt = _opt(name, kernel=True)
    if route == "flatten":
        _flatten_route(opt)
    p = opt.config.p
    rec = _round(opt)
    assert rec.watch.grads == p and rec.watch.updates == p
    assert rc.check_round_steps(rec, p) == []
    assert rc.check_kernel_flatten_once(rec, p) == []
    kinds = [k for (k, _i, g, u) in rec.watch.flattens
             if k in ("flatten", "leaves") and g == u + 1]
    assert kinds == [handoff] * p
    assert rc.check_no_host_sync(rec) == [] and rc.check_no_f64(rec) == []
    names = {o.name for o in rec.ops}
    assert "aten::mm" in names or "aten::addmm" in names or names


def _item_grads(params, batch):
    loss, grads = rc.toy_grads_fn(params, batch)
    scale = float(batch["x"].sum().item())      # a host read a step
    return loss, {k: g + scale for k, g in grads.items()}


def _f64_grads(params, batch):
    loss, grads = rc.toy_grads_fn(params, batch)
    return loss, {k: (g.double() * 1.0).float() for k, g in grads.items()}


@pytest.mark.parametrize("seed,check,needle", [
    ("item", rc.check_no_host_sync, "aten::_local_scalar_dense"),
    ("f64", rc.check_no_f64, "float64 operand"),
    ("flatten", None, "flattened more than once at the round boundary"),
    ("steps", None, "expected p=3 local steps"),
    ("grad_twice", None, "step 2 hands 2 tree(s) to the layout"),
    ("grad_none", None, "step 2 hands 0 tree(s) to the layout"),
])
def test_seeded_violation_caught(seed, check, needle):
    opt = _opt(kernel=seed in ("flatten", "grad_twice", "grad_none"))
    grads_fn = {"item": _item_grads, "f64": _f64_grads}.get(
        seed, rc.toy_grads_fn)
    if seed == "flatten":
        inner = opt.mat_state
        params = rc.toy_params(K)
        state = opt.init(params)

        def mat_state(plan, st):
            plan.flatten(params)          # the params flattened again
            return inner(plan, st)
        opt.mat_state = mat_state
        rec = rc.trace_round(opt, params, state, rc.toy_batches(3, K))
        v = rc.check_kernel_flatten_once(rec, 3)
        assert any("(the params among them)" in m for m in v), v
    elif seed in ("grad_twice", "grad_none"):
        # step 2's gradient read as leaves and also flattened, or
        # replaced by a matrix that is not the gradient
        inner = opt.local_step_mat

        def local_step_mat(x_mat, mats, g, step):
            calls[0] += 1
            if calls[0] == 2:
                if seed == "grad_twice":
                    kops.as_matrix(g)        # flattened beside the leaf read
                else:                        # never reaches the layout
                    g = torch.zeros_like(x_mat)
            return inner(x_mat, mats, g, step)
        calls = [0]
        opt.local_step_mat = local_step_mat
        v = rc.check_kernel_flatten_once(_round(opt), 3)
    elif seed == "steps":
        params = rc.toy_params(K)
        batches = rc.toy_batches(4, K)             # a step too many
        rec = rc.trace_round(opt, params, opt.init(params), batches)
        v = rc.check_round_steps(rec, 3)
    else:
        v = check(_round(opt, grads_fn))
    assert v and any(needle in m for m in v), v
    if seed == "item":
        assert "inside the gradient" in v[0]


def test_seeded_dead_column_caught():
    """A live worker that reads a dead worker's column: the executed masked
    mix is corrupted in its per-round table, and the mask check names the
    two workers."""
    from repro_torch.testing import chaos_script, membership_for
    ms = membership_for(K, 6, chaos_script(K, 6, seed=7))
    comm = DenseComm(ring(K), membership=ms, device="cpu")
    assert rc.check_membership_mask(comm) == []
    r = next(r for r in range(comm.round_cycle)
             if not comm.active_at(r).all())
    act = comm.active_at(r)
    dead = int((~act).nonzero()[0][0])
    live = int(act.nonzero()[0][0])
    comm._Wm[r, live, dead] += 0.25
    comm._Wm[r, live, live] -= 0.25
    v = rc.check_membership_mask(comm, rounds=[r])
    assert any(f"active worker {live} reads weight" in m
               and f"masked-out worker {dead}" in m for m in v), v


def test_seeded_extra_exchange_caught():
    """A sharded round that gossips again inside its steps: the boundary
    check sees a collective after step 1 of 2 and one exchange too many
    (a fake group of 8 ranks, rank 0's view)."""
    from repro_torch.analysis.run import (check_sharded_pack, tiny_run)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    with fake_group(K):
        mesh = make_mesh((K,), ("data",), device=torch.device("cpu"))
        pack = build_train(tiny_run("pd_sgdm", "sign", True, "static"), mesh)
        expected = 2 * 1
        assert check_sharded_pack(pack, expected=expected) == []
        opt = pack.opt
        inner = opt.local_step_mat
        calls = []

        def local_step_mat(x_mat, mats, g_mat, step):
            calls.append(1)
            if len(calls) % 2 == 0:        # an exchange after step 1
                x_mat = opt._gossip_mat(x_mat, 0)
            return inner(x_mat, mats, g_mat, step)
        opt.local_step_mat = local_step_mat
        v = check_sharded_pack(pack, expected=expected)
    assert any("after step 1 of p=2" in m for m in v), v
    assert any("expected 2 collective-permute send(s) a round, found 4" in m
               for m in v), v


def test_schedule_switch_and_its_violation():
    """The one-peer schedule applies its period's 3 distinct matrices,
    chosen on the device; a comm whose every round is round 0's fails."""
    from repro_torch.core.topology import make_schedule
    sched = make_schedule("one_peer_exp", (K,))
    comm = DenseComm(sched, device="cpu")
    assert rc.check_schedule_switch(comm, sched.period) == []
    comm._Ws = comm._Ws[:1].expand_as(comm._Ws).clone()
    v = rc.check_schedule_switch(comm, sched.period)
    assert v and "applies 1 distinct matrices" in v[0]


def test_require_raises():
    rc.require([])
    with pytest.raises(rc.ContractViolation, match="boom"):
        rc.require(["boom"])
