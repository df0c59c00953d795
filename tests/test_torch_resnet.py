"""The port's ResNet-20 against the reference's, on the reference's params
and the reference's class-stream batches.

Forward values, losses and per-worker gradients are held to rtol 1e-4,
atol 1e-5: XLA:CPU and oneDNN sum the convolutions in different orders.
Parameter conversion is exact.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import ClassStreamCfg as RCfg  # noqa: E402
from repro.data.synthetic import class_batch as r_class_batch  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import DenseComm, make_optimizer, ring  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.train.trainer import SimTrainer  # noqa: E402


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


WIDTH, K, BATCH = 4, 8, 2
RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _ref_params(width=WIDTH):
    init = jax.jit(r_resnet.resnet20_init, static_argnames=("width",))
    return jax.tree_util.tree_map(
        np.array, init(jax.random.PRNGKey(0), width=width))


def _stacked_ref_params():
    """K workers that differ (the reference's init plus per-worker noise)."""
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: (x[None] + 0.01 * rng.standard_normal((K,) + x.shape)
                   ).astype(np.float32), _ref_params())


def _ref_batch(step=0):
    fn = jax.jit(r_class_batch, static_argnums=0)
    return jax.tree_util.tree_map(
        np.array, fn(RCfg(batch=BATCH, n_workers=K, seed=0), step))


def _port_batch(b):
    return {"images": torch.from_numpy(b["images"]),
            "labels": torch.from_numpy(b["labels"]).long()}


def _nested(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v.numpy()
    return out


@pytest.mark.parametrize("stacked", [False, True])
def test_params_from_reference_round_trips(stacked):
    tree = _stacked_ref_params() if stacked else _ref_params()
    ours = params_from_reference(tree, "cpu")
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(ours) == paths                   # the reference's leaf order
    for name, leaf in zip(paths, leaves):
        assert ours[name].dtype == torch.float32
        np.testing.assert_array_equal(ours[name].numpy(), leaf)
    back = _nested(ours)
    assert jax.tree_util.tree_structure(back) == treedef
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        np.testing.assert_array_equal(a, b)


def test_init_matches_reference_layout():
    g = torch.Generator().manual_seed(0)
    ours = resnet.resnet20_init(g, width=16, device="cpu")
    theirs = params_from_reference(_ref_params(16), "cpu")
    assert list(ours) == list(theirs)
    for name in ours:
        assert ours[name].shape == theirs[name].shape, name
        if name.endswith("scale"):
            assert torch.equal(ours[name], torch.ones_like(ours[name]))
        elif name.endswith("bias") or name == "head.b":
            assert torch.equal(ours[name], torch.zeros_like(ours[name]))
    # He-normal convs: std √(2/fan_in) = √(2/(3·3·16)) for a 16→16 conv
    assert abs(float(ours["s0b0.conv1"].std()) - (2 / 144) ** 0.5) < 0.02
    assert set(dict(resnet.ResNet20(16, device="meta").named_parameters())) \
        == set(ours)


def test_apply_and_loss_match_reference():
    params = _ref_params()
    b = jax.tree_util.tree_map(lambda x: np.array(x[0]), _ref_batch())
    ours = params_from_reference(params, "cpu")
    logits = resnet.resnet20_apply(ours, torch.from_numpy(b["images"]))
    rlogits = r_resnet.resnet20_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(b["images"]))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(rlogits),
                               rtol=RTOL, atol=ATOL)
    loss, aux = resnet.resnet20_loss(ours, _port_batch(b))
    rloss, raux = r_resnet.resnet20_loss(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, b))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL)
    assert float(aux["acc"]) == float(raux["acc"])


def test_per_worker_grads_match_reference():
    params = _stacked_ref_params()
    batch = _ref_batch(3)
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"))
    trainer = SimTrainer(resnet.resnet20_loss, opt, device="cpu")
    grads, losses = trainer._grad(params_from_reference(params, "cpu"),
                                  _port_batch(batch))
    rlosses, rgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: r_resnet.resnet20_loss(p, b)[0])))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, batch))
    np.testing.assert_allclose(losses.numpy(), np.asarray(rlosses),
                               rtol=RTOL, atol=ATOL)
    rgrads = params_from_reference(
        jax.tree_util.tree_map(np.asarray, rgrads), "cpu")
    assert list(grads) == list(rgrads)
    for name in rgrads:
        np.testing.assert_allclose(grads[name].numpy(), rgrads[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_stride2_block_pads_like_xla_same():
    """The stage-1 entry block (3×3 stride-2 convs and the 1×1 stride-2
    projection) on an even 32×32 input: XLA's "SAME" pads (0, 1), which
    symmetric padding=1 would not reproduce."""
    params = _ref_params()
    x = np.random.default_rng(5).standard_normal((2, 32, 32, WIDTH),
                                                 dtype=np.float32)
    want = np.asarray(r_resnet._block(
        jax.tree_util.tree_map(jnp.asarray, params["s1b0"]), jnp.asarray(x),
        2))
    sub = {k[len("s1b0."):]: v for k, v in
           params_from_reference(params, "cpu").items()
           if k.startswith("s1b0.")}
    block = resnet._template(WIDTH, 10).s1b0
    got = torch.func.functional_call(
        block, sub, (torch.from_numpy(x).permute(0, 3, 1, 2),))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 16, 16, 2 * WIDTH)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the same conv with PyTorch's symmetric padding lands elsewhere
    w = torch.from_numpy(params["s1b0"]["conv1"]).permute(3, 2, 0, 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    sym = torch.nn.functional.conv2d(xt, w, stride=2, padding=1)
    same = resnet._conv(xt, torch.from_numpy(params["s1b0"]["conv1"]), 2)
    assert sym.shape == same.shape
    assert not torch.allclose(sym, same)
