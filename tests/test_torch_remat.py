"""``remat`` in the port (``Model.apply``/``Model.loss``'s ``remat``
argument; the reference's ``jax.checkpoint`` of each repeat,
``src/repro/models/transformer.py:198-205``).

With ``remat="full"`` each repeat's pass over the block pattern runs
under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
backward recomputes the pass from its input with the same ops on the same
tensors, so on the CPU the loss and every gradient equal those of
``remat="none"`` bit for bit, on every LM smoke config.  Under a
``torch.func`` transform ``"full"`` raises (those transforms do not
support the saved-tensor hooks the checkpoint is built on), and
``build_train`` hands ``run.parallel.remat`` to the rank's plain-autograd
gradient (``launch/runtime.py``'s ``worker_grad_fn``), which checkpoints
once per repeat.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import (ASSIGNED,  # noqa: E402
                                          get_smoke_config)
from repro_torch.configs.shapes import train_batch_arrays  # noqa: E402
from repro_torch.launch.runtime import worker_grad_fn  # noqa: E402
from repro_torch.models import make_model  # noqa: E402

SEQ = 32     # two chunks of the smoke SSD; the VLM's 16 patches + 16 tokens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at
    once (see ``tests/test_torch_sharded.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch):
    cfg = get_smoke_config(arch).model
    model = make_model(cfg)
    params = {k: v.unsqueeze(0) for k, v in model.init(
        torch.Generator().manual_seed(3), device="cpu").items()}
    batch = train_batch_arrays(cfg, 1, 2, SEQ, torch.Generator().manual_seed(4),
                               device="cpu")
    batch["labels"][0, 0, :3] = -1                 # masked labels
    return model, params, batch


@pytest.mark.parametrize("arch", ASSIGNED)
def test_full_equals_none_bit_for_bit(arch):
    model, params, batch = _setup(arch)
    calls = []
    inner = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return inner(*a, **kw)

    torch.utils.checkpoint.checkpoint = counted
    try:
        loss_f, grads_f = worker_grad_fn(model, "full")(params, batch)
    finally:
        torch.utils.checkpoint.checkpoint = inner
    assert calls == [False] * model.cfg.n_repeats
    loss_n, grads_n = worker_grad_fn(model, "none")(params, batch)
    assert torch.isfinite(loss_f)
    assert torch.equal(loss_f, loss_n)
    assert list(grads_f) == list(grads_n) == list(params)
    for k in grads_n:
        assert grads_f[k].shape == params[k].shape
        assert torch.equal(grads_f[k], grads_n[k]), k


def test_full_refused_under_torch_func():
    model, params, batch = _setup("olmo-1b")
    one = {k: v[0] for k, v in params.items()}
    b = {k: v[0] for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="saved-tensor hooks"):
        torch.func.grad(lambda p: model.loss(p, b, remat="full")[0])(one)
    with pytest.raises(ValueError, match="remat"):
        model.loss(one, b, remat="some")
    # the dense path's vmap keeps remat="none"
    g, _ = torch.func.vmap(torch.func.grad_and_value(
        lambda p, bb: model.loss(p, bb)[0]))(params, batch)
    _, want = worker_grad_fn(model, "none")(params, batch)
    for k in g:
        torch.testing.assert_close(g[k], want[k], rtol=1e-5, atol=1e-6)


def test_build_train_applies_remat():
    """``build_train`` passes ``run.parallel.remat`` (the reference's
    default, "full") to the rank's gradient: one checkpointed pass per
    repeat in a step, none with "none"; the step's loss is the same."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.launch.spawn import free_port
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    inner = torch.utils.checkpoint.checkpoint
    try:
        mesh = make_mesh((1,), ("data",), device="cpu")
        run = get_smoke_config("olmo-1b")
        assert run.parallel.remat == "full"
        losses = {}
        for remat in ("full", "none"):
            pack = build_train(dataclasses.replace(
                run, parallel=dataclasses.replace(run.parallel,
                                                  remat=remat)), mesh)
            params, state = pack.init_fn(0)
            batch = train_batch_arrays(run.model, 1, 2, SEQ,
                                       torch.Generator().manual_seed(5),
                                       device="cpu")
            calls = []

            def counted(*a, **kw):
                calls.append(1)
                return inner(*a, **kw)
            torch.utils.checkpoint.checkpoint = counted
            _, _, losses[remat] = pack.train_step(params, state, batch, 0)
            torch.utils.checkpoint.checkpoint = inner
            assert len(calls) == (run.model.n_repeats if remat == "full"
                                  else 0)
        assert torch.equal(losses["full"], losses["none"])
    finally:
        torch.utils.checkpoint.checkpoint = inner
        dist.destroy_process_group()
