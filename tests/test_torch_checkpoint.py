"""The port's checkpoints (``repro_torch.checkpoint``): the round trip of
every optimizer family's full state, the state keys the sharded runtime
knows, the elastic K→K′ restore against the reference's on the same
values, and bit-identical resumes through ``ShardedTrainer`` in four gloo
ranks on the CPU (the port's counterparts of
``tests/test_checkpoint_resume.py:369-394``).

The resume runs (tiny LM, p = 2) are spawned once, by a module fixture:
per case an unbroken run and runs checkpointed at a round boundary and
off it (then continued on the per-step path up to the next boundary),
each resumed in the same ranks from its checkpoint; the final params and
state must equal the unbroken run's bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as r_ckpt  # noqa: E402
from repro.checkpoint import elastic as r_elastic  # noqa: E402
from repro.core.gossip import ShardedComm as RSharded  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import elastic  # noqa: E402
from repro_torch.core import (DenseComm, make_compressor,  # noqa: E402
                              make_optimizer, ring)
from repro_torch.core.gossip import ShardedComm  # noqa: E402
from repro_torch.launch.mesh import WorkerMesh  # noqa: E402
from repro_torch.launch.runtime import check_state_keys  # noqa: E402
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


_OPTIMIZERS = [
    ("pd_sgdm", {}, {"m", "step"}),
    ("cpd_sgdm", {"gamma": 0.5, "compressor": "sign"},
     {"m", "step", "xhat"}),
    ("mt_dsgdm", {}, {"m", "step", "c", "g_prev"}),
    ("mt_dsgdm", {"compressor": "sign"}, {"m", "step", "c", "g_prev"}),
    ("qg_dsgdm", {}, {"m", "step", "xprev"}),
    ("pd_sgdm", {"overlap": True}, {"m", "step", "mix"}),
    ("mt_dsgdm", {"overlap": True}, {"m", "step", "c", "g_prev", "mix"}),
    ("qg_dsgdm", {"overlap": True}, {"m", "step", "xprev", "mix"}),
    ("cpd_sgdm", {"gamma": 0.5, "compressor": "identity", "overlap": True},
     {"m", "step", "xhat", "mix"}),
]
_OPT_IDS = ["pd", "cpd", "mt", "mt_compressed", "qg", "pd_overlap",
            "mt_overlap", "qg_overlap", "cpd_overlap"]


def _kw(kw):
    kw = dict(kw)
    if "compressor" in kw:
        kw["compressor"] = make_compressor(kw["compressor"])
    return kw


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name,kw,keys", _OPTIMIZERS, ids=_OPT_IDS)
def test_checkpoint_roundtrip_all_optimizers(tmp_path, name, kw, keys):
    """Every family's whole state → npz → restore, bit for bit."""
    opt = make_optimizer(name, DenseComm(ring(8), device="cpu"), eta=0.05,
                         mu=0.9, p=2, **_kw(kw))
    gen = torch.Generator().manual_seed(0)
    params = {"layer.w": torch.randn((8, 12), generator=gen),
              "layer.b": torch.randn((8, 3), generator=gen)}
    state = opt.init(params)
    assert set(state) == keys
    g = {k: torch.full_like(v, 0.1) for k, v in params.items()}
    steps = 4 if kw.get("overlap") else 3
    for _ in range(steps):
        params, state = opt.step(state, params, g)
    if kw.get("overlap"):
        assert int(state["mix"]["phase"]) == 1
    else:
        params, state = opt.comm_round(state, params)
    ckpt.save(str(tmp_path), 3, params=params, opt_state=state)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    out = ckpt.restore(str(tmp_path), 3, {
        "params": {k: meta(v) for k, v in params.items()},
        "opt_state": elastic._map(meta, state)}, device="cpu")
    want, got = _leaves({"p": params, "s": state}), _leaves(
        {"p": out["params"], "s": out["opt_state"]})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_bf16_leaf_and_shape_check(tmp_path):
    x = torch.randn((2, 5)).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 7, params={"x": x})
    out = ckpt.restore(str(tmp_path), 7, {"params": {"x": x}})
    assert out["params"]["x"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["x"], x)
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(str(tmp_path), 7, {"params": {"x": torch.zeros(3, 5)}})


def _mesh():
    """A one-axis mesh of 8 ranks, without a process group: a
    ``ShardedComm`` on it builds nothing collective."""
    return WorkerMesh(("w",), (8,), 0, torch.device("cpu"), "gloo",
                      {"w": None})


@pytest.mark.parametrize("name,kw,keys", _OPTIMIZERS, ids=_OPT_IDS)
def test_state_keys_cover_every_state_key(name, kw, keys):
    """``check_state_keys`` knows every entry of every family's sharded
    state (the counterpart of ``_state_spec``'s check): CPD's adds its
    per-shift copies ``xhat_nbrs``; overlapped CPD is dense-only, so its
    state is checked on the dense backend."""
    comm = ShardedComm(ring(8), axis_names=("w",), mesh=_mesh())
    if name == "cpd_sgdm" and kw.get("overlap"):
        with pytest.raises(ValueError, match="dense-only"):
            make_optimizer(name, comm, eta=0.05, mu=0.9, p=2, **_kw(kw))
        comm = DenseComm(ring(8), device="cpu")
    elif name == "cpd_sgdm":
        keys = keys | {"xhat_nbrs"}
    opt = make_optimizer(name, comm, eta=0.05, mu=0.9, p=2, **_kw(kw))
    params = {"layer.w": torch.empty((1, 12), device="meta")}
    state = opt.init(params)
    marks = check_state_keys(state)
    assert set(marks) == keys
    assert marks["step"] is False
    for k in keys - {"step", "mix"}:
        assert marks[k] is True
    if "xhat_nbrs" in keys:
        assert sorted(state["xhat_nbrs"]) == ["ax0_sh+1", "ax0_sh-1"]
    if "mix" in keys:
        assert marks["mix"]["phase"] is False
        assert all(v for kk, v in marks["mix"].items() if kk != "phase")
    with pytest.raises(KeyError):
        check_state_keys({**state, "unknown": state["step"]})


# ------------------------------------------------------------ K → K′
def _fleet(k, seed=0):
    """A K-worker PD/CPD-style state: params, m, x̂ and the ring's
    per-neighbour copies, as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = {"w": rng.standard_normal((k, 3, 4)).astype(f32),
              "b": rng.standard_normal((k, 4)).astype(f32)}
    xhat = {n: (v + 0.5).astype(f32) for n, v in params.items()}
    state = {"m": {n: rng.standard_normal(v.shape).astype(f32)
                   for n, v in params.items()},
             "step": np.asarray(8, np.int32), "xhat": xhat,
             "xhat_nbrs": {f"ax0_sh{sh:+d}": {
                 n: np.roll(v, -sh, axis=0) for n, v in xhat.items()}
                 for sh in (1, -1)}}
    return params, state


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _meta_k(tree, k):
    def f(v):
        shape = tuple(v.shape)
        shape = ((k,) + shape[1:]) if shape else shape
        return torch.empty(shape, dtype=_torch(v).dtype, device="meta")
    return elastic._map(f, tree)


def _struct_k(tree, k):
    def f(v):
        shape = tuple(np.shape(v))
        shape = ((k,) + shape[1:]) if shape else shape
        return jax.ShapeDtypeStruct(shape, np.asarray(v).dtype)
    return jax.tree_util.tree_map(f, tree)


@pytest.mark.parametrize("old_k,new_k", [(4, 6), (6, 4), (4, 4)])
def test_restore_elastic_equals_reference(tmp_path, old_k, new_k):
    """The same values saved by the reference (from numpy) and by the port
    (from tensors), restored into K′ workers by each: equal arrays, the
    joiners' x̂ copies re-derived under the new ring."""
    params, state = _fleet(old_k)
    r_dir, p_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    r_ckpt.save(r_dir, 8, params=params, opt_state=state)
    ckpt.save(p_dir, 8, params=_torch(params), opt_state=_torch(state))
    p_new, s_new = _fleet(new_k)
    want = r_elastic.restore_elastic(
        r_dir, 8, params_template=_struct_k(p_new, new_k),
        state_template=_struct_k(s_new, new_k),
        comm=RSharded(r_ring(new_k), axis_names=("w",)))
    got = elastic.restore_elastic(
        p_dir, 8, params_template=_meta_k(p_new, new_k),
        state_template=_meta_k(s_new, new_k),
        comm=DenseComm(ring(new_k), device="cpu"), device="cpu")
    assert elastic._peek_worker_count(p_dir, 8) == old_k
    w = _leaves({"p": want["params"], "s": want["opt_state"]})
    g = _leaves({"p": got["params"], "s": got["opt_state"]})
    assert set(w) == set(g)
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                      err_msg=k)


def test_repartition_donors_and_derived_copies():
    params, state = _fleet(4, seed=1)
    for old_k, new_k in ((4, 6), (4, 3), (4, 9)):
        np.testing.assert_array_equal(elastic.donor_map(old_k, new_k),
                                      r_elastic.donor_map(old_k, new_k))
        got = elastic.repartition(_torch(params), old_k, new_k)
        want = r_elastic.repartition(params, old_k, new_k)
        for k in params:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    keys = sorted(state["xhat_nbrs"])
    got = elastic._derive_nbrs(_torch(state["xhat"]), keys, 4)
    want = r_elastic._derive_nbrs(state["xhat"], keys, 4)
    for key in keys:
        for n in params:
            np.testing.assert_array_equal(got[key][n].numpy(),
                                          np.asarray(want[key][n]))
            # the copies equal their owners' x̂ (the commit protocol)
            np.testing.assert_array_equal(got[key][n].numpy(),
                                          state["xhat_nbrs"][key][n])


# ------------------------------------------------------------ resume
CASES = {
    # label: (optimizer, knobs, steps, checkpoint steps)
    "pd": ("pd_sgdm", {}, 8, (4, 5)),
    "pd_kernel": ("pd_sgdm", {"use_kernel": True}, 8, (4, 5)),
    "pd_overlap": ("pd_sgdm", {"overlap": True, "use_kernel": True}, 8,
                   (4,)),
    "pd_onepeer": ("pd_sgdm", {"schedule": "one_peer_exp"}, 8, (2,)),
    "mt_onepeer": ("mt_dsgdm", {"schedule": "one_peer_exp"}, 8, (2,)),
    # CPD sign with its per-shift copies, both layouts
    "cpd": ("cpd_sgdm", {"compressor": "sign"}, 8, (4, 5)),
    "cpd_kernel": ("cpd_sgdm", {"compressor": "sign", "use_kernel": True},
                   8, (4, 5)),
}


@pytest.fixture(scope="module")
def resumed():
    return spawn_ranks(ranks.resume_scenarios, 4, (CASES,),
                       backend="gloo", device="cpu")


def _flat(x):
    return _leaves({"p": x[0], "s": x[1]})


@pytest.mark.parametrize("label", list(CASES))
def test_resume_bit_identical(resumed, label):
    _, _, steps, stops = CASES[label]
    for rank_res in resumed:
        res = rank_res[label]
        base = _flat(res["unbroken"])
        for stop in stops:
            params, state, ran, first = res[stop]
            # the resumed run starts at the checkpoint's step
            assert ran == steps - stop and first[0] >= stop
            got = _flat((params, state))
            assert set(got) == set(base)
            for k in base:
                np.testing.assert_array_equal(got[k], base[k],
                                              err_msg=f"{label}@{stop} {k}")
        if label == "pd_overlap":
            # the restored in-flight payload was live (phase armed)
            assert int(res[4][1]["mix"]["phase"]) == 1


# ------------------------------------------------ CPD's copies, K → K′
CPD_KW = {"compressor": "sign", "use_kernel": True}


@pytest.fixture(scope="module")
def cpd_grown(tmp_path_factory):
    """CPD sign on the kernel layout, 4 ranks, 4 steps, checkpointed at
    the end; then restored into 6 ranks."""
    d = str(tmp_path_factory.mktemp("cpd_k4"))
    old = spawn_ranks(ranks.write_checkpoint, 4, (d, 4, "cpd_sgdm", CPD_KW),
                      backend="gloo", device="cpu")
    new = spawn_ranks(ranks.elastic_resume, 6, (d, "cpd_sgdm", CPD_KW),
                      backend="gloo", device="cpu")
    return old, new


def _replica_contract(states):
    """Every rank's copy ``ax0_sh{s}`` has the bits of the x̂ of rank
    (k + s) mod K, on the ring of ``len(states)``."""
    k = len(states)
    for r, s in enumerate(states):
        assert sorted(s["xhat_nbrs"]) == ["ax0_sh+1", "ax0_sh-1"]
        for key, copy in s["xhat_nbrs"].items():
            src = states[(r + int(key[len("ax0_sh"):])) % k]["xhat"]
            for leaf, v in copy.items():
                np.testing.assert_array_equal(v, src[leaf],
                                              err_msg=f"rank {r} {key}")


def test_cpd_restore_elastic_rederives_copies(cpd_grown):
    """K = 4 → K′ = 6: survivors keep their x̂, joiners take their donors',
    and every re-derived copy satisfies the replica contract on the new
    ring (as it did on the old one at the checkpoint)."""
    old, new = cpd_grown
    _replica_contract([s for _, s in old])
    _replica_contract([s for _, s in new])
    for r, (params, state) in enumerate(new):
        donor_p, donor_s = old[r % 4]
        for leaf, v in state["xhat"].items():
            np.testing.assert_array_equal(v, donor_s["xhat"][leaf])
        for leaf, v in params.items():
            np.testing.assert_array_equal(v, donor_p[leaf])
