"""The port's topologies, dense gossip backend and byte accounting against
the reference's.

Topologies, shifted views and bytes are exact.  ``DenseComm.mix`` is
``W @ flat``, an 8-term reduction whose order neither side pins (BLAS on
both), so it is held to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as r_gossip  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.models.resnet import resnet20_init as r_resnet20_init  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.core.gossip import DenseComm, gossip_bytes_per_round  # noqa: E402

TOPOLOGIES = {
    "ring1": lambda m: m.ring(1),
    "ring2": lambda m: m.ring(2),
    "ring8": lambda m: m.ring(8),
    "torus2x4": lambda m: m.torus((2, 4)),
    "complete8": lambda m: m.complete(8),
}


def _stacked_tree(K, seed=0):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((K, 3, 3, 2, 4), dtype=np.float32),
            "gn": {"bias": rng.standard_normal((K, 4), dtype=np.float32),
                   "scale": rng.standard_normal((K, 4), dtype=np.float32)}}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_equals_reference(name):
    ours, theirs = TOPOLOGIES[name](top), TOPOLOGIES[name](r_top)
    assert ours.name == theirs.name
    np.testing.assert_array_equal(ours.W, theirs.W)
    assert ours.shifts == theirs.shifts
    assert tuple(ours.axis_sizes) == tuple(theirs.axis_sizes)
    assert ours.degree == theirs.degree
    assert ours.self_weight() == theirs.self_weight()
    np.testing.assert_array_equal(ours.structure_matrix(),
                                  theirs.structure_matrix())


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_dense_comm_equals_reference(name):
    ours = DenseComm(TOPOLOGIES[name](top), device="cpu")
    theirs = r_gossip.DenseComm(TOPOLOGIES[name](r_top))
    K = ours.topology.n_workers
    tree = _stacked_tree(K, seed=K)
    ptree = params_from_reference(tree, "cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)

    mixed = ours.mix(ptree)
    rmixed = params_from_reference(
        jax.tree_util.tree_map(np.asarray, theirs.mix(jtree)), "cpu")
    for k in rmixed:
        np.testing.assert_allclose(mixed[k].numpy(), rmixed[k].numpy(),
                                   rtol=1e-6, atol=0)

    assert ours.weights() == theirs.weights()
    assert ours.self_weight() == theirs.self_weight()
    views = ours.shift_views(ptree)
    rviews = theirs.shift_views(jtree)
    assert list(views) == list(rviews)
    for key, rview in rviews.items():
        rview = params_from_reference(
            jax.tree_util.tree_map(np.asarray, rview), "cpu")
        for k in rview:
            assert torch.equal(views[key][k], rview[k])


@pytest.mark.parametrize("name", ["ring8", "torus2x4"])
def test_roll_equals_reference(name):
    ours = DenseComm(TOPOLOGIES[name](top), device="cpu")
    theirs = r_gossip.DenseComm(TOPOLOGIES[name](r_top))
    leaf = np.random.default_rng(3).standard_normal((8, 5, 1024 // 8),
                                                    dtype=np.float32)
    for (ax, sh, _w) in ours.topology.shifts:
        np.testing.assert_array_equal(
            ours._roll(torch.from_numpy(leaf), ax, sh).numpy(),
            np.asarray(theirs._roll(jnp.asarray(leaf), ax, sh)))


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_gossip_bytes_equal_reference(name):
    shapes = jax.eval_shape(lambda k: r_resnet20_init(k, width=4),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    ours = DenseComm(TOPOLOGIES[name](top), device="cpu")
    theirs = r_gossip.DenseComm(TOPOLOGIES[name](r_top))
    ptree = params_from_reference(tree, "cpu")
    assert gossip_bytes_per_round(ptree, ours) == \
        r_gossip.gossip_bytes_per_round(tree, theirs)
    assert gossip_bytes_per_round(ptree, ours, bits_per_element=1.25) == \
        r_gossip.gossip_bytes_per_round(tree, theirs, bits_per_element=1.25)


def test_dense_comm_refuses_what_this_slice_does_not_port():
    """A wire dtype other than f32 and bf16 is refused, as in the
    reference; the bf16 wire and the stale mix are ported (held against
    the reference in tests/test_torch_hierarchical.py and
    tests/test_torch_overlap.py)."""
    churn = DenseComm(top.ring(8), membership=top.full_membership(8),
                      device="cpu")
    tree = {"w": torch.arange(24.0).reshape(8, 3)}
    assert torch.equal(churn.stale_mix(tree, r=0)["w"], churn.mix(tree)["w"])
    bf16 = DenseComm(top.ring(8), wire_dtype="bfloat16", device="cpu")
    assert bf16.wire_itemsize == 2
    with pytest.raises(ValueError) as ours:
        DenseComm(top.ring(8), wire_dtype="float16", device="cpu")
    with pytest.raises(ValueError) as ref:
        r_gossip.DenseComm(r_top.ring(8), wire_dtype="float16")
    assert str(ours.value) == str(ref.value)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        DenseComm(top.ring(8))              # device defaults to "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
