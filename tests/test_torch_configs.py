"""The port's configs against the reference's: every field of every
registered architecture, its smoke reduction and its long-context
variant, compared exactly by ``dataclasses.asdict``; the derived counts;
the input shapes and the concrete batch's structure.  The port's
``ModelCfg`` has fields the reference's lacks (``PORT_ONLY``, DeepSeek-V2's
expert layer): every field the reference has is compared, and the port's
own are held at their defaults in every registered config."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.configs import shapes as r_shapes  # noqa: E402
from repro.configs.base import OptimCfg as ROptimCfg  # noqa: E402
from repro.configs.base import ParallelCfg as RParallelCfg  # noqa: E402
from repro_torch.configs import registry, shapes  # noqa: E402
from repro_torch.configs.base import PORT_ONLY  # noqa: E402
from repro_torch.configs.base import OptimCfg, ParallelCfg  # noqa: E402

NAMES = list(r_registry.ARCHS)


def _assert_same(ours, theirs):
    """``asdict(ours) == asdict(theirs)`` over every field of the
    reference's, and the port-only fields of ``ours`` (a ``RunCfg`` or a
    ``ModelCfg``) at their defaults."""
    a = dataclasses.asdict(ours)
    model = a["model"] if "model" in a else a
    assert {k: model.pop(k) for k in PORT_ONLY} == PORT_ONLY
    assert a == dataclasses.asdict(theirs)


def test_registry_names():
    assert list(registry.ARCHS) == NAMES == registry.list_archs()
    assert registry.ASSIGNED == r_registry.ASSIGNED
    assert len(registry.ASSIGNED) == 10
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    ours, theirs = registry.get_config(name), r_registry.get_config(name)
    _assert_same(ours, theirs)
    m, rm = ours.model, theirs.model
    assert m.params_count() == rm.params_count()
    assert m.active_params_count() == rm.active_params_count()
    assert (m.resolved_head_dim, m.n_repeats) == (rm.resolved_head_dim,
                                                  rm.n_repeats)
    long_ours = registry.long_ctx_variant(m)
    long_theirs = r_registry.long_ctx_variant(rm)
    _assert_same(long_ours, long_theirs)
    for shape in shapes.SHAPES.values():
        assert registry.shape_supported(m, shape) == \
            r_registry.shape_supported(rm, r_shapes.SHAPES[shape.name])


@pytest.mark.parametrize("name", NAMES)
def test_smoke_config_equals_reference(name):
    ours, theirs = registry.get_smoke_config(name), \
        r_registry.get_smoke_config(name)
    _assert_same(ours, theirs)
    assert ours.model.params_count() == theirs.model.params_count()


def test_defaults_and_validation():
    """The optimizer and parallel defaults (TPU-only fields included, as
    inert data) equal the reference's; a pattern that does not divide the
    layer count is refused as there."""
    assert dataclasses.asdict(OptimCfg()) == dataclasses.asdict(ROptimCfg())
    assert dataclasses.asdict(ParallelCfg()) == \
        dataclasses.asdict(RParallelCfg())
    jamba = registry.get_config("jamba-1.5-large-398b").model
    with pytest.raises(ValueError, match="not divisible"):
        dataclasses.replace(jamba, n_layers=12)


def test_shapes_and_batch_arrays():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_shapes.SHAPES.items()}
    for name in ("olmo-1b", "musicgen-medium", "internvl2-76b"):
        cfg = registry.get_smoke_config(name).model
        rcfg = r_registry.get_smoke_config(name).model
        theirs = r_shapes.train_batch_arrays(rcfg, 3, 2, 40,
                                             jax.random.PRNGKey(0))
        g = torch.Generator().manual_seed(0)
        ours = shapes.train_batch_arrays(cfg, 3, 2, 40, g, device="cpu")
        assert sorted(ours) == sorted(theirs)
        for k, v in theirs.items():
            assert tuple(ours[k].shape) == v.shape
            assert str(ours[k].dtype).split(".")[-1] == str(v.dtype)
        again = shapes.train_batch_arrays(
            cfg, 3, 2, 40, torch.Generator().manual_seed(0), device="cpu")
        assert all(torch.equal(ours[k], again[k]) for k in ours)
        if "tokens" in ours:
            tok = ours["tokens"].numpy()
            assert tok.min() >= 0 and tok.max() < cfg.vocab
            assert np.unique(tok).size > 1
