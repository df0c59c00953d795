"""The sharded round's launch and collective checks
(``repro_torch.analysis.wire_check``, ``analysis.collectives``), the
counterparts of ``tests/test_analysis_sharded.py:117-127`` and
``tests/test_hlo_two_level.py:45-100``: the tiny sharded grid is green on a
fake process group of 8 ranks; a stray worker-axis ``all_gather`` and an
out-of-place momentum launch are caught; the bytes a rank hands to
``isend`` (and, on a two-level round, to its node-group all-reduces) equal
the reference's ``bytes_per_comm_round`` / ``hier_bytes_per_level`` for the
same tree, exactly; and the recorder's ring formula equals ``hlo_parse``'s
for each op.  Each fake group is destroyed when its block ends."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.hlo_parse import parse_collectives  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.topology import hierarchical as r_hier  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro_torch.analysis import round_check as rc  # noqa: E402
from repro_torch.analysis import wire_check as wc  # noqa: E402
from repro_torch.analysis.collectives import (CommRecorder,  # noqa: E402
                                              ring_wire_bytes)
from repro_torch.analysis.run import (check_sharded_pack,  # noqa: E402
                                      fake_group, phase_sharded,
                                      round_batches, tiny_run)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.runtime import (build_train, make_steps,  # noqa: E402
                                        per_worker)

K = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_tiny_grid_green(capsys):
    assert phase_sharded(False) == []
    out = capsys.readouterr().out
    assert out.count("  ok ") == 10 and "FAIL" not in out


def _pack(opt_name="pd_sgdm", kernel=False, **kw):
    mesh = make_mesh((K,), ("data",), device=torch.device("cpu"))
    return build_train(tiny_run(opt_name, "sign", kernel, "static", **kw),
                       mesh)


def _traced(pack, launches=None, after=None):
    """One checked round of ``pack`` after a warm one (loopback wire);
    ``after(params)`` runs inside the round, after the train round."""
    p = pack.opt.config.p
    mesh = pack.layout.mesh
    params, state = pack.init_fn(0)
    batches = round_batches(pack, p)
    with CommRecorder(mesh, loopback=True):
        params, state, _ = pack.train_round(params, state, batches, 0)

    def round_fn(pr, st, gf, b):
        out = make_steps(pack.opt, gf)[1](pr, st, b, p)
        if after is not None:
            after(out[0])
        return out
    with wc.watch_momentum(launches if launches is not None else []):
        return rc.trace_round(pack.opt, params, state, batches,
                              round_fn=round_fn, grads_fn=pack.grad_fn,
                              mesh=mesh, loopback=True)


def test_seeded_worker_axis_all_gather_caught():
    with fake_group(K):
        pack = _pack()
        mesh, group = pack.layout.mesh, pack.layout.worker_group

        def stray(params):
            leaf = next(iter(params.values()))
            mesh.all_gather(leaf.contiguous(), group, 0)
        clean = _traced(pack)
        assert wc.check_sharded_round(pack, clean.calls) == []
        rec = _traced(pack, after=stray)
        v = wc.check_sharded_round(pack, rec.calls)
    assert len(v) == 1 and "all-gather" in v[0] and "over data" in v[0], v
    assert "outside the gradient" in v[0]


@pytest.mark.parametrize("route", ["flatten", "leaves"])
def test_seeded_out_of_place_momentum_caught(route, monkeypatch):
    """The watch sees each momentum call of a sharded kernel round (a
    ``worker_dim=False`` plan), in place with x and m written over, and
    catches an out-of-place one; ``leaves``: the gradient handed over as
    ``ops.Leaves`` and read through the leaf table (as K = 1);
    ``flatten``: handed over flattened into a matrix."""
    from repro_torch.kernels import ops as kops
    with fake_group(K):
        pack = _pack(kernel=True)
        if route == "flatten":
            step = pack.opt.local_step_mat
            monkeypatch.setattr(pack.opt, "local_step_mat", lambda x, mats,
                                g, s: step(x, mats, kops.as_matrix(g), s),
                                raising=False)
        good = []
        _traced(pack, good)
        assert len(good) == 2 and wc.check_in_place(good, expected=2) == []
        opt = pack.opt

        def out_of_place(x_mat, mats, g_mat, step):
            cfg = opt.config
            x_new, m_new = kops.momentum_update_mat(
                x_mat, mats["m"], g_mat, mu=cfg.mu, lr=cfg.lr(step),
                weight_decay=cfg.weight_decay, inplace=False)
            return x_new, {**mats, "m": m_new}
        opt.local_step_mat = out_of_place
        bad = []
        rec = _traced(pack, bad)
        v = wc.check_sharded_round(pack, rec.calls, bad)
    assert len(v) == 2 and all("out of place" in m for m in v), v


def _ref_tree(pack):
    return {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
            for k, v in per_worker(pack.params_struct).items()}


@pytest.mark.parametrize("opt_name,kernel,node_size,wire", [
    ("pd_sgdm", False, 0, "float32"),
    ("pd_sgdm", True, 0, "float32"),
    ("pd_sgdm", False, 0, "bfloat16"),
    ("cpd_sgdm", False, 0, "float32"),
    ("pd_sgdm", False, 4, "float32"),
    ("pd_sgdm", True, 4, "float32"),
    ("pd_sgdm", False, 4, "bfloat16"),
])
def test_recorded_bytes_equal_the_reference(opt_name, kernel, node_size,
                                            wire):
    with fake_group(K):
        pack = _pack(opt_name, kernel, node_size=node_size, wire_dtype=wire)
        rec = _traced(pack)
    sent = sum(c.wire_bytes for c in rec.calls
               if c.op == "collective-permute")
    top = r_hier(2, 4) if node_size else r_ring(K)
    from repro.core import make_compressor
    ropt = r_make_optimizer(
        opt_name, RDenseComm(top, wire_dtype=wire), p=2,
        use_kernel=kernel, kernel_interpret=True,
        compressor=make_compressor("sign") if opt_name == "cpd_sgdm"
        else None)
    tree = _ref_tree(pack)
    if not node_size:
        assert sent == ropt.bytes_per_comm_round(tree)
        return
    if kernel:
        # the reference's kernel-path payload, the used_rows × 1024 matrix
        # (its sharded HierarchicalComm's; the dense backend takes leaves)
        ropt._kernel_hier_active = lambda: True
    levels = ropt.hier_bytes_per_level(tree)
    assert sent == levels["inter_site"]          # rank 0 leads node 0
    intra = sum(c.wire_bytes for c in rec.calls
                if c.op == "all-reduce" and c.group == node_size)
    assert intra == levels["intra_wire"]
    assert wc.check_hier_wire_bytes(rec.calls, levels,
                                    node_size=node_size) == []


_CANNED = """
HloModule canned

ENTRY %main (a: f32[1024]) -> f32[1024] {
  %ar = f32[1024]{0} all-reduce(%a), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[4096]{0} all-gather(%a), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[256]{0} reduce-scatter(%a), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %cp = f32[1024]{0} collective-permute(%a), source_target_pairs={{0,1},{1,0}}
}
"""


@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter", "collective-permute"])
def test_ring_formula_equals_hlo_parse(op):
    """The same collective, parsed from HLO by the reference and recorded
    by the port from a meta call over a group of 4: the same result bytes,
    group and ring wire bytes."""
    ref = next(c for c in parse_collectives(_CANNED).calls if c.op == op)
    assert ring_wire_bytes(op, ref.result_bytes, ref.group) == ref.wire_bytes
    with fake_group(K):
        mesh = make_mesh((2,), ("pod",), device=torch.device("meta"),
                         model_axis=4)
        group = mesh.group(("model",))
        t = torch.empty(1024, device="meta")
        with CommRecorder(mesh) as rec:
            if op == "all-reduce":
                mesh.all_reduce(t, group)
            elif op == "all-gather":
                assert mesh.all_gather(t, group, 0).shape == (4096,)
            elif op == "reduce-scatter":
                assert mesh.reduce_scatter(t, group, 0).shape == (256,)
            else:
                assert mesh.p2p([(t, 1, 0)], [(torch.empty_like(t), 1, 0)]
                                ) == 4096
    (got,) = rec.calls
    assert (got.op, got.result_bytes, got.wire_bytes) == \
        (ref.op, ref.result_bytes, ref.wire_bytes)
    assert got.group == ref.group
    if op != "collective-permute":
        assert got.axes == ("model",)


def test_sharded_check_on_a_schedule_sees_each_period_pattern():
    """The one-peer schedule's sharded rounds: three rounds, three distinct
    peer patterns; a static ring's two rounds repeat one."""
    with fake_group(K):
        pack = build_train(tiny_run("pd_sgdm", "sign", False,
                                    "one_peer_exp"),
                           make_mesh((K,), ("data",),
                                     device=torch.device("cpu")))
        assert check_sharded_pack(pack, schedule="one_peer_exp",
                                  rounds=pack.opt.comm.period) == []
        ring_pack = _pack()
        v = check_sharded_pack(ring_pack, schedule="one_peer_exp",
                               rounds=2)
    assert v and "1 distinct exchange patterns" in v[0]
    assert np.isfinite(1.0)
