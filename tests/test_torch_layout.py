"""The port's flatten-once ``KernelPlan`` against the reference's, and the
guard that keeps the port free of JAX and of the reference package.

The layout is pure data movement, so every check here is an exact
equality: slot geometry, rows, the wire extent, row counts, the flattened
matrix and the round trip.
"""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.astlint import lint_paths  # noqa: E402
from repro.kernels.ops import KernelPlan as RPlan  # noqa: E402
from repro.models.resnet import resnet20_init as r_resnet20_init  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.ops import KernelPlan, PLAN_BLOCK_ROWS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3


def _tree(kind):
    if kind == "tiny":
        rng = np.random.default_rng(0)
        return {"w": rng.standard_normal((3, 700), dtype=np.float32),
                "b": rng.standard_normal((5,), dtype=np.float32)}
    # the reference's ResNet-20 tree structure (traced, not run), filled
    # with numpy draws
    width = {"resnet_w16": 16, "resnet_w4": 4}[kind]
    shapes = jax.eval_shape(lambda k: r_resnet20_init(k, width=width),
                            jax.random.PRNGKey(1))
    rng = np.random.default_rng(width)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32), shapes)


def _stack(tree):
    return jax.tree_util.tree_map(
        lambda x: np.stack([x + i for i in range(K)]), tree)


@pytest.mark.parametrize("worker_dim", [False, True])
@pytest.mark.parametrize("kind", ["resnet_w16", "resnet_w4", "tiny"])
def test_kernel_plan_equals_reference(kind, worker_dim):
    tree = _tree(kind)
    if worker_dim:
        tree = _stack(tree)
    ours = KernelPlan.for_tree(params_from_reference(tree, "cpu"),
                               worker_dim=worker_dim)
    theirs = RPlan.for_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                            worker_dim=worker_dim)
    assert [(s.shape, s.size, s.row_start, s.n_rows) for s in ours.slots] == \
        [(s.shape, s.size, s.row_start, s.n_rows) for s in theirs.slots]
    assert (ours.rows, ours.used_rows, ours.n_valid) == \
        (theirs.rows, theirs.used_rows, theirs.n_valid)
    assert ours.block_rows == theirs.block_rows == PLAN_BLOCK_ROWS
    np.testing.assert_array_equal(ours.row_counts().numpy(),
                                  np.asarray(theirs.row_counts()))

    ptree = params_from_reference(tree, "cpu")
    mat = ours.flatten(ptree)
    rmat = theirs.flatten(jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(rmat))
    back = ours.unflatten(mat)
    assert list(back) == list(ptree)
    for name in ptree:
        assert torch.equal(back[name], ptree[name])
    wire = ours.wire(mat)
    assert wire.shape[-2] == ours.used_rows
    assert torch.equal(ours.pad_wire(wire), mat)
    np.testing.assert_array_equal(wire.numpy(), np.asarray(theirs.wire(rmat)))


def test_row_counts_on_the_device_tiled_over_workers():
    """The optimizer's counts operand: the reference's ``row_counts()``
    tiled over the K workers, exactly, on the matrix's device, built once
    per plan geometry and reused by every later round."""
    from repro_torch.core import DenseComm, make_optimizer, ring
    tree = params_from_reference(_stack(_tree("resnet_w4")), "cpu")
    plan = KernelPlan.for_tree(tree, worker_dim=True)
    mat = plan.flatten(tree)
    opt = make_optimizer("cpd_sgdm", DenseComm(ring(K), device="cpu"))
    counts = opt.row_counts(plan, mat)
    theirs = RPlan.for_tree(jax.tree_util.tree_map(jnp.asarray,
                                                   _stack(_tree("resnet_w4"))),
                            worker_dim=True).row_counts()
    assert counts.dtype == torch.float32 and counts.device == mat.device
    np.testing.assert_array_equal(counts.numpy(),
                                  np.tile(np.asarray(theirs), (K, 1)))
    assert opt.row_counts(plan, mat) is counts
    assert plan.row_counts("cpu").shape == (plan.rows, 1)


def test_resnet20_width16_geometry():
    """The paper's ResNet-20: 61 leaves, 272,282 params, 310 of 512 rows."""
    plan = KernelPlan.for_tree(params_from_reference(_tree("resnet_w16"),
                                                     "cpu"))
    assert len(plan.slots) == 61 and plan.n_valid == 272_282
    assert plan.used_rows == 310 and plan.rows == 512
    assert plan.names[0] == "gn0.bias" and plan.names[-1] == "stem"


def test_unflatten_returns_views():
    tree = params_from_reference(_stack(_tree("tiny")), "cpu")
    plan = KernelPlan.for_tree(tree, worker_dim=True)
    mat = plan.flatten(tree)
    views = plan.unflatten(mat)
    mat.add_(1.0)
    for name in tree:
        assert torch.equal(views[name], tree[name] + 1.0)


def _examples():
    root = os.path.join(REPO, "examples")
    return [os.path.join(root, fn) for fn in sorted(os.listdir(root))
            if fn.startswith("torch_") and fn.endswith(".py")]


def _port_sources():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _dirs, files in os.walk(root):
        for fn in sorted(files):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from _examples()


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for module in ("core/cpdsgdm.py", "core/wire.py", "core/compression.py",
                   "kernels/sign_compress.py", "kernels/qsgd_quant.py",
                   "kernels/topk_select.py", "kernels/row_gather.py",
                   "data/synthetic.py", "configs/base.py",
                   "configs/registry.py", "configs/shapes.py",
                   "configs/olmo_1b.py", "models/layers.py",
                   "models/attention.py", "models/moe.py",
                   "models/mamba2.py", "models/transformer.py",
                   "launch/__init__.py", "launch/mesh.py",
                   "launch/spawn.py", "launch/runtime.py",
                   "launch/train.py", "checkpoint/checkpoint.py",
                   "checkpoint/elastic.py", "train/trainer.py"):
        assert os.path.join("src", "repro_torch", module) in scanned
    for example in ("torch_quickstart.py", "torch_compression_ablation.py",
                    "torch_noniid_ablation.py",
                    "torch_pretrain_decentralized.py"):
        assert os.path.join("examples", example) in scanned
    forbidden = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                forbidden.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert forbidden == []
    errors = lint_paths([os.path.join(REPO, "src", "repro_torch")]
                        + _examples(), base=REPO)
    assert errors == [], "\n".join(str(e) for e in errors)


_NO_GROUP_AT_IMPORT = """
import importlib, pkgutil, sys
import torch.distributed as dist

def refuse(*a, **k):
    raise AssertionError("a process group created at import time")

dist.init_process_group = dist.new_group = refuse
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not dist.is_initialized()
print(len(names))
"""


def test_no_process_group_at_import():
    """Importing every module of the port (the sharded runtime's
    ``launch`` package too) creates no process group: ``init_process_group``
    and ``new_group`` are only called by a rank's own setup."""
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", _NO_GROUP_AT_IMPORT],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 50
