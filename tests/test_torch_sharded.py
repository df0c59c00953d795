"""The port's sharded backend (``ShardedComm``, ``HierarchicalComm``) in
eight gloo ranks on the CPU, held against the reference's dense backend
on the same numpy inputs.

One module fixture spawns the ranks once and runs every scenario of
``tests/torch_sharded_ranks.py`` (the ranks import no JAX); each test
asserts on its slice of the results:

* the mix of a two-leaf tree on the ring, the 2 × 4 torus and
  ``exponential(8)`` (whose ±4 shifts name one peer: two exchanges with
  one rank in one batch), on the f32 and the bf16 wire, the one-peer
  schedule and a churn script (round r given on the host): bit for bit
  the reference's sharded formula (``ShardedComm._mix_with``, the views
  summed in the topology's order) replayed on the stacked arrays, and
  within 2 ulps of each element's largest input against
  ``DenseComm.mix``, a matmul that sums in another order;
* ``hierarchical(2, 4)`` on the flat and on the two-axis layout, without
  a codec and with the identity, sign and QSGD codecs, on the tree and on
  the kernel matrix (``mix_mat``), against an oracle built from the
  reference's codecs on the node means;
* three rounds of PD (tree and kernel, every graph and wire), C-SGDM, MT,
  QG and overlapped PD on a least-squares model against the reference's
  dense rounds: within 4.8e-7 (ROADMAP C.6's bar for the dense path);
* the bytes handed to ``isend`` (counted by wrapping
  ``dist.batch_isend_irecv`` in each rank) against the reference's
  ``bytes_per_round_cycle``/``gossip_bytes_per_round``, exactly, and per
  level on the hierarchical graphs (``inter_site`` on the leaders, 0
  elsewhere; the ``all_reduce`` bytes against ``intra_result``);
* the raw exchanges (``receive_payload`` keeps u8/i32/f32 payloads,
  ``shift_views``, ``receive_payload_committed`` ships nothing from a
  source that does not commit);
* the refusals: the reference's for CPD-SGDM and MT's compressed
  tracking on the sharded backend (overlap, the complete and the
  hierarchical graphs, a schedule, perms under membership), rand-k as the
  inter codec, membership on a two-axis mesh, profile B and ``inner="dp"``
  on a model axis of 2 (item 12b.4), a device round index;
* the launcher, ``repro_torch.launch.train`` with four gloo ranks, and
  its ``--resume``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.core.compression import (QSGDCompressor as RQSGD,  # noqa: E402
                                    SignCompressor as RSign)
from repro.core.gossip import DenseComm as RDense  # noqa: E402
from repro.core.gossip import HierarchicalComm as RHier  # noqa: E402
from repro.core.gossip import gossip_bytes_per_round as r_bytes  # noqa: E402
from repro.core.gossip import hier_bytes_per_round as r_hier_bytes  # noqa: E402
from repro.core.wire import IdentityCodec as RIdentity  # noqa: E402
from repro.core.wire import make_codec as r_make_codec  # noqa: E402
from repro_torch.launch.spawn import spawn_ranks  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402


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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, P, ROUNDS = 8, 2, 3
ROWS, USED = 256, 200
ROUND_BAR = 4.8e-7
HYPER = dict(eta=0.05, mu=0.9, p=P, weight_decay=1e-4)
CHURN = ranks.CHURN

# label: (graph, optimizer, knobs); the static graphs on the kernel layout,
# schedules and churn on the tree (their kernel wire ships whole rows in
# the reference too, so only the tree's bytes are the accounted ones)
FAMILIES = {
    "pd/ring/tree": ("ring", "pd_sgdm", dict(HYPER)),
    "pd/ring/kernel": ("ring", "pd_sgdm", dict(HYPER, use_kernel=True)),
    "pd/ring_bf16/kernel": ("ring", "pd_sgdm",
                            dict(HYPER, use_kernel=True, wire="bfloat16")),
    "pd/torus/kernel": ("torus", "pd_sgdm", dict(HYPER, use_kernel=True)),
    "pd/exp/kernel": ("exp", "pd_sgdm", dict(HYPER, use_kernel=True)),
    "pd/onepeer/tree": ("onepeer", "pd_sgdm", dict(HYPER)),
    "pd/churn/tree": ("churn", "pd_sgdm", dict(HYPER)),
    "pd/hier_flat/kernel": ("hier_flat", "pd_sgdm",
                            dict(HYPER, use_kernel=True)),
    "pd/hier_2axis/kernel": ("hier_2axis", "pd_sgdm",
                             dict(HYPER, use_kernel=True)),
    "c_sgdm/kernel": ("ring", "c_sgdm", dict(HYPER, p=1, use_kernel=True)),
    "mt/ring/kernel": ("ring", "mt_dsgdm", dict(HYPER, use_kernel=True)),
    "mt/ring/tree": ("ring", "mt_dsgdm", dict(HYPER)),
    "qg/ring/kernel": ("ring", "qg_dsgdm", dict(HYPER, use_kernel=True)),
    "pd_overlap/ring/kernel": ("ring", "pd_sgdm",
                               dict(HYPER, use_kernel=True, overlap=True)),
}


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    mat = rng.standard_normal((K, ROWS, 1024)).astype(f32)
    mat[:, USED:] = 0.0
    w0 = rng.standard_normal((4, 3)).astype(f32)
    return {
        "x": {"w": rng.standard_normal((K, 3, 700)).astype(f32),
              "b": rng.standard_normal((K, 5)).astype(f32)},
        "mat": mat, "used": USED, "rounds": ROUNDS,
        # every worker from one x0 (the paper's), its own batches
        "q_params": {"w": np.broadcast_to(w0, (K, 4, 3)).copy(),
                     "b": np.zeros((K, 3), f32)},
        "q_batches": {"x": rng.standard_normal((ROUNDS * P, K, 4, 4))
                      .astype(f32),
                      "y": rng.standard_normal((ROUNDS * P, K, 4, 3))
                      .astype(f32)},
        "families": FAMILIES,
        "source_ok": np.array([r % 3 != 0 for r in range(K)]),
    }


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    res = spawn_ranks(ranks.sharded_scenarios, K, (inp,), backend="gloo",
                      device="cpu")
    return inp, res


def _stack(res, section, label):
    got = [r[section][label] for r in res]
    if isinstance(got[0], dict):
        return {k: np.concatenate([g[k] for g in got]) for k in got[0]}
    return np.concatenate(got)


def _ulps(a, b, x):
    """max |a − b| per element in units of the last place of the largest
    |input| of that element over the workers (``x``, K-stacked)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    big = np.abs(np.asarray(x, np.float32)).max(axis=0)
    return np.max(np.abs(a.astype(np.float64) - b) / np.spacing(big))


def _r_graph(kind):
    return {"ring": r_top.ring(K), "exp": r_top.make_topology(
        "exponential", (K,)), "torus": r_top.torus((2, 4)),
        "onepeer": r_top.make_schedule("one_peer_exp", (K,)),
        "churn": r_top.ring(K), "hier_flat": r_top.hierarchical(2, 4),
        "hier_2axis": r_top.hierarchical(2, 4)}[kind]


def _r_membership(kind):
    return (r_top.membership_from_events(K, 3, CHURN) if kind == "churn"
            else None)


def _one(tree):
    return {k: v[0] for k, v in tree.items()}


def test_raw_exchanges(run):
    """``receive_payload``, ``shift_views`` and ``receive_payload_committed``:
    each array from the (axis, shift) neighbour in its own dtype, the
    ring's neighbour views, and, pruned to committing sources, zeros
    where the source does not commit and no bytes shipped by it."""
    inp, res = run
    x = {k: torch.from_numpy(v) for k, v in inp["x"].items()}
    pay = [ranks.payload_of({k: v[r:r + 1] for k, v in x.items()}, r)
           for r in range(K)]
    stacked = {k: np.concatenate([p[k].numpy() for p in pay]) for k in pay[0]}
    got = _stack(res, "raw", "payload")
    for k, v in stacked.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], np.roll(v, -1, axis=0))
    nbytes = sum(v[0].nbytes for v in stacked.values())
    assert [r["raw"]["payload_bytes"] for r in res] == [nbytes] * K
    for sh in (1, -1):
        for k, v in inp["x"].items():
            np.testing.assert_array_equal(
                np.concatenate([r["raw"]["views"][sh][k] for r in res]),
                np.roll(v, -sh, axis=0))
    ok = inp["source_ok"]
    got = _stack(res, "raw", "committed")
    for k, v in stacked.items():
        want = np.roll(v, 1, axis=0) * np.roll(ok, 1).reshape(
            (K,) + (1,) * (v.ndim - 1)).astype(v.dtype)
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], want)
    assert [r["raw"]["committed_bytes"] for r in res] == \
        [nbytes if ok[r] else 0 for r in range(K)]


def _r_view_sum(top, x, wire="float32", act=None):
    """The reference's sharded round (``ShardedComm._mix_with`` and
    ``_mix_with_masked``, ``gossip.py:467-578``) replayed on the K-stacked
    ``x`` with ``DenseComm._roll`` for the exchanges: per topology axis,
    ``Σ w·view`` in f32 in the topology's order, the neighbour views
    through the wire dtype; under ``act`` the pruned exchanges with each
    receiver's own coefficient and the lost mass on its self weight."""
    roll = RDense(top)._roll

    def wire_rt(v):
        if wire == "bfloat16":
            return v.astype(jnp.bfloat16).astype(jnp.float32)
        return v

    y = jnp.asarray(x, jnp.float32)
    if act is not None and not np.all(act):
        n = K
        ks = np.arange(n)
        acc_terms, off = [], np.zeros(n)
        for (_ax, sh, w) in top.shifts:
            if sh % n == 0:
                continue
            coeff = np.where(act & act[(ks + sh) % n], w, 0.0)
            anyp = any(act[s] and act[(s - sh) % n] for s in range(n))
            off += coeff
            acc_terms.append((coeff.astype(np.float32), anyp, sh))
        shape = (K,) + (1,) * (y.ndim - 1)
        acc = y * jnp.asarray((1.0 - off).astype(np.float32)).reshape(shape)
        for coeff, anyp, sh in acc_terms:
            if anyp:
                acc = acc + wire_rt(roll(y, 0, sh)) * jnp.asarray(
                    coeff).reshape(shape)
        return np.asarray(acc)
    per_axis = {}
    for (ax, sh, w) in top.shifts:
        per_axis.setdefault(ax, []).append((sh, w))
    for ax in sorted(per_axis):
        acc = None
        for sh, w in per_axis[ax]:
            v = y if sh == 0 else wire_rt(roll(y, ax, sh))
            term = v * jnp.float32(w)
            acc = term if acc is None else acc + term
        y = acc
    return np.asarray(y)


@pytest.mark.parametrize("kind", ["ring", "torus", "exp"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_mix_equals_dense(run, kind, wire):
    """Exact against the reference's sharded formula; within 2 ulps of the
    largest input of each element against ``DenseComm.mix``'s matmul
    (measured: 2.0 on the ring, 1.5 on ``exp``).  The torus's bf16 wire
    is per axis, as the reference's sharded backend and both kernel
    rounds run it: ``DenseComm.mix`` rounds only the original x."""
    inp, res = run
    label = f"{kind}/{wire}"
    got = _stack(res, "mix", label)
    comm = RDense(_r_graph(kind), wire_dtype=wire)
    want = comm.mix(jax.tree_util.tree_map(jnp.asarray, inp["x"]))
    for k, x in inp["x"].items():
        np.testing.assert_array_equal(
            got[k], _r_view_sum(_r_graph(kind), x, wire), err_msg=label)
        if not (kind == "torus" and wire == "bfloat16"):
            assert _ulps(got[k], want[k], x) <= 2.0, (label, k)
    # the bytes handed to isend: the reference's per-worker figure, on
    # every rank
    want_b = r_bytes(_one(inp["x"]), comm)
    assert [r["bytes"][label] for r in res] == [want_b] * K


@pytest.mark.parametrize("what", ["onepeer", "churn", "churn_stale"])
def test_scheduled_mix_with_host_round(run, what):
    """Round r of a schedule and of a churn script, r on the host: exact
    against the reference's sharded formula, within 2 ulps of the largest
    input against ``DenseComm``."""
    inp, res = run
    graph = "onepeer" if what == "onepeer" else "churn"
    memb = _r_membership(graph)
    comm = RDense(_r_graph(graph), membership=memb)
    x = jax.tree_util.tree_map(jnp.asarray, inp["x"])
    for r in range(3):
        label = f"{what}/r{r}"
        got = _stack(res, "mix", label)
        want = (comm.stale_mix(x, r=r) if what == "churn_stale"
                else comm.mix(x, r=r))
        act = None
        if memb is not None:
            act = memb.active_at(r + 1 if what == "churn_stale" else r)
        for k in got:
            np.testing.assert_array_equal(
                got[k], _r_view_sum(comm.topology_at(r), inp["x"][k],
                                    act=act), err_msg=label)
            assert _ulps(got[k], want[k], inp["x"][k]) <= 2.0, (label, k)
        if what != "churn_stale":
            # dead edges ship nothing: the mean over the ranks is the
            # reference's per-worker figure
            mean = np.mean([rr["bytes"][label] for rr in res])
            assert mean == pytest.approx(r_bytes(_one(inp["x"]), comm, r=r),
                                         rel=0, abs=1e-9)


def _r_codec(name):
    return {"identity": RIdentity(),
            "sign": r_make_codec(RSign(block=1024)),
            "qsgd": r_make_codec(RQSGD(levels=7, block=1024))}.get(name)


def _hier_oracle(x, codec, wire, used=None):
    """The two-level round on K-stacked ``x`` from the reference's pieces:
    node means, the inter factor's self term on the mean, each neighbour
    node's mean through the codec (or the bf16 round trip), the result on
    every member."""
    top = r_top.hierarchical(2, 4)
    n, m = 2, 4
    xa = jnp.asarray(x, jnp.float32).reshape((n, m) + x.shape[1:]).mean(1)
    acc = xa * jnp.float32(r_top.hierarchical_self_weight(top))
    for (sh, w) in r_top.hierarchical_inter_shifts(top):
        src = jnp.roll(xa, -sh, axis=0)
        if used is not None:
            src = src[:, :used]
        if codec is not None:
            dec = jnp.stack([codec.unpack(codec.pack(s), s.size, s.shape,
                                          jnp.float32) for s in src])
        elif wire == "bfloat16":
            dec = src.astype(jnp.bfloat16).astype(jnp.float32)
        else:
            dec = src
        if used is not None:
            dec = jnp.pad(dec, ((0, 0), (0, x.shape[1] - used), (0, 0)))
        acc = acc + dec * jnp.float32(w)
    return np.asarray(jnp.repeat(acc, m, axis=0))


@pytest.mark.parametrize("layout", ["hier_flat", "hier_2axis"])
@pytest.mark.parametrize("codec", ["none", "identity", "sign", "qsgd",
                                   "bf16"])
def test_hierarchical_mix(run, layout, codec):
    """Within 2 ulps of the largest input of each element (measured 2.0:
    the in-node mean is an all_reduce sum over the node, in gloo's order,
    over m; the oracle's is ``jnp.mean``)."""
    inp, res = run
    rcodec = _r_codec(codec)
    wire = "bfloat16" if codec == "bf16" else "float32"
    label = f"{layout}/{codec}"
    got = _stack(res, "mix", label)
    for k, v in inp["x"].items():
        assert _ulps(got[k], _hier_oracle(v, rcodec, wire), v) <= 2.0, (
            label, k)
    if codec != "bf16":
        mat = _stack(res, "mix", label + "/mat")
        want = _hier_oracle(inp["mat"], rcodec, wire, used=USED)
        assert _ulps(mat, want, inp["mat"]) <= 2.0, label
    # bytes per level: inter_site on each shipping rank (the leaders on
    # the flat layout, every rank on the two-axis one), the all-reduces'
    # results on every rank
    comm = RHier(r_top.hierarchical(2, 4),
                 axis_names=("w",) if layout == "hier_flat"
                 else ("node", "member"),
                 wire_dtype=wire, inter_codec=rcodec)
    lv = r_hier_bytes(_one(inp["x"]), comm)
    ships = [(r % 4 == 0) or layout == "hier_2axis" for r in range(K)]
    assert [r["bytes"][label] for r in res] == \
        [lv["inter_site"] if s else 0 for s in ships]
    assert [r["reduced"][label] for r in res] == [lv["intra_result"]] * K
    if codec != "bf16":
        lvm = r_hier_bytes([jax.ShapeDtypeStruct((USED * 1024,),
                                                 jnp.float32)], comm)
        assert [r["bytes"][label + "/mat"] for r in res] == \
            [lvm["inter_site"] if s else 0 for s in ships]
        # the in-node levels run on the used rows too: accounted ≡ shipped
        assert [r["reduced"][label + "/mat"] for r in res] == \
            [lvm["intra_result"]] * K


def _r_quad_grads(params, batch):
    def loss(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        return 0.5 * jnp.mean(r * r)
    losses, grads = jax.vmap(jax.value_and_grad(loss))(params, batch)
    return losses.mean(), grads


def _r_opt(label, use_kernel=False):
    kind, name, kw = FAMILIES[label]
    kw = dict(kw)
    wire = kw.pop("wire", "float32")
    kw["use_kernel"] = use_kernel
    if kind == "hier_flat" and use_kernel:
        comm = RHier(r_top.hierarchical(2, 4), axis_names=("w",),
                     wire_dtype=wire)
    elif kind == "hier_2axis" and use_kernel:
        comm = RHier(r_top.hierarchical(2, 4), axis_names=("a", "b"),
                     wire_dtype=wire)
    else:
        comm = RDense(_r_graph(kind), membership=_r_membership(kind),
                      wire_dtype=wire)
    return r_make_optimizer(name, comm, **kw)


@pytest.mark.parametrize("label", list(FAMILIES))
def test_rounds_equal_dense(run, label):
    """Three rounds of each family against the reference's dense tree
    rounds from the same x0 on the same batches; the bytes of the rounds
    against the reference's cycle (its kernel figure where the port runs
    the kernel round)."""
    inp, res = run
    opt = _r_opt(label)
    params = jax.tree_util.tree_map(jnp.asarray, inp["q_params"])
    state = opt.init(params)
    p = opt.config.p
    for rnd in range(ROUNDS):
        b = {k: jnp.asarray(v[rnd * p:(rnd + 1) * p])
             for k, v in inp["q_batches"].items()}
        params, state, _ = opt.round(state, params, _r_quad_grads, b)
    got = {k: np.concatenate([r["rounds"][label]["params"][k] for r in res])
           for k in inp["q_params"]}
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(params[k]), rtol=0,
                                   atol=ROUND_BAR, err_msg=label)
    kernel = FAMILIES[label][2].get("use_kernel", False)
    cycle = _r_opt(label, use_kernel=kernel).bytes_per_round_cycle(
        _one(inp["q_params"]))
    want = sum(cycle[r % len(cycle)] for r in range(ROUNDS))
    sent = [r["rounds"][label]["bytes"] for r in res]
    if label.startswith("c_sgdm"):
        assert sent == [0] * K          # an all_reduce mean, no P2P
    elif "hier_flat" in label:
        # leaders ship the node's share: the mean over ranks is the
        # amortized figure
        assert np.mean(sent) == want
        assert all(s == 0 for i, s in enumerate(sent) if i % 4)
    elif "churn" in label:
        assert np.mean(sent) == pytest.approx(want, rel=0, abs=1e-9)
    else:
        assert sent == [want] * K


def test_refusals(run):
    _, res = run
    for r in res:
        ref = r["refused"]
        assert all(v is not None for v in ref.values()), ref
        # CPD-SGDM's and MT's compressed tracking: the reference's refusals
        assert "dense-only" in ref["cpd_overlap"]
        assert "'complete' has no neighbour state" in ref["cpd_complete"]
        assert "sharded hierarchical" in ref["cpd_hier"]
        assert "static topology" in ref["cpd_schedule"]
        assert "perm graphs" in ref["cpd_perm_membership"]
        assert "sharded hierarchical" in ref["mt_hier"]
        assert "'complete' has no per-neighbour wire" in ref["mt_complete"]
        assert "static topology" in ref["mt_schedule"]
        assert not any("12b" in v for k, v in ref.items()
                       if k.startswith(("cpd", "mt")))
        # profile B and inner="dp" build and run a step; a mesh axis
        # profile B gives no role ("w") is refused
        acc = r["accepted"]
        assert acc["model_axis"][0] == (("pod",), "model", "data", None)
        assert acc["model_axis_inner_dp"][0] == (("w",), None, None,
                                                 "model")
        assert all(np.isfinite(v[1]) for v in acc.values())
        assert "no role" in ref["model_axis_no_role"]
        assert not any("12b" in v for v in ref.values())
        assert "randk" in ref["randk_inter"]
        assert "single worker axis" in ref["membership_2axis"]
        assert "host" in ref["sharded_r_tensor"]


def test_nccl_refused_without_a_gpu_per_rank():
    from repro_torch.launch.mesh import init_workers
    with pytest.raises(ValueError, match="gloo"):
        init_workers("nccl", rank=0, world_size=2,
                     init_method="tcp://127.0.0.1:1", device="cpu")


def _launch(args, tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--smoke", "--workers", "4", "--dist-backend", "gloo",
         "--device", "cpu", "--ckpt-dir", str(tmp), "--ckpt-every", "4"]
        + args, env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return [ln for ln in r.stdout.splitlines() if ln.startswith("step")]


def test_launcher_runs_and_resumes(tmp_path):
    first = _launch(["--steps", "8"], tmp_path)
    assert first[0].split()[1] == "0" and first[-1].split()[1] == "7"
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000008"]
    resumed = _launch(["--steps", "12", "--resume"], tmp_path)
    assert resumed[0].split()[1] == "8" and resumed[-1].split()[1] == "11"
