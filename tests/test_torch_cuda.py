"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and nvcc: it carries the ``cuda``
marker and skips without a card.  The file imports neither JAX nor the
reference package, so it runs on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernels pin their rounding (``__fmul_rn``/``__fadd_rn``), so each must
equal its plain version bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LANE  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.kernels.ref import gossip_mix_ref, momentum_update_ref  # noqa: E402


def _mats(seed, n, rows):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, LANE), dtype=np.float32)
            for _ in range(n)]


@pytest.mark.cuda
def test_cuda_kernels_bit_exact_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for rows in (4096, 333):               # the main path's rows; ragged
        x, m, g = (torch.from_numpy(a).to(dev) for a in _mats(rows, 3, rows))
        lr = torch.tensor(0.05, device=dev)
        for nesterov in (False, True):
            before = momentum_update.launches
            got = momentum_update(x, m, g, lr, mu=0.9, wd=1e-4,
                                  nesterov=nesterov)
            want = momentum_update_ref(x, m, g, lr, mu=0.9, wd=1e-4,
                                       nesterov=nesterov)
            torch.cuda.synchronize()
            assert momentum_update.launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        ws = (1 / 3, 1 / 3, 1 / 3)
        before = gossip_mix.launches
        y = gossip_mix([x, m, g], weights=ws)
        torch.cuda.synchronize()
        assert gossip_mix.launches == before + 1
        assert torch.equal(y, gossip_mix_ref([x, m, g], ws))
    xs = [torch.from_numpy(a).to(dev) for a in _mats(8, 8, 333)]
    for n in range(1, 9):
        ws = tuple(0.1 + 0.05 * j for j in range(n))
        assert torch.equal(gossip_mix(xs[:n], weights=ws),
                           gossip_mix_ref(xs[:n], ws))
    with pytest.raises(ValueError):
        momentum_update(x, m, g.t().contiguous().t(), lr, mu=0.9)


@pytest.mark.cuda
def test_kernel_round_on_card_matches_tree_round():
    """One PD-SGDM round of ResNet-20 (width 4, K = 8 ring, batch 2) on the
    card: p momentum launches and one gossip launch, and the params within
    atol 1e-4 / rtol 1e-3 of the tree round, which launches no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.data.synthetic import ClassStreamCfg, class_batch
    from repro_torch.models.resnet import resnet20_init, resnet20_loss
    from repro_torch.train.trainer import SimTrainer
    K, P = 8, 4
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        init = resnet20_init(torch.Generator().manual_seed(0), width=4)
        params = {k: v.unsqueeze(0).repeat((K,) + (1,) * v.dim())
                  for k, v in init.items()}
        cfg = ClassStreamCfg(batch=2, n_workers=K)
        out, launches = {}, {}
        for use_kernel in (True, False):
            opt = make_optimizer("pd_sgdm", DenseComm(ring(K)), p=P, eta=0.1,
                                 mu=0.9, weight_decay=1e-4,
                                 use_kernel=use_kernel)
            before = (momentum_update.launches, gossip_mix.launches)
            out[use_kernel], _, _ = SimTrainer(resnet20_loss, opt).train(
                params, lambda t: class_batch(cfg, t), P)
            launches[use_kernel] = (momentum_update.launches - before[0],
                                    gossip_mix.launches - before[1])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
    assert launches == {True: (P, 1), False: (0, 0)}
    for name, want in out[False].items():
        assert torch.allclose(out[True][name], want, rtol=1e-3, atol=1e-4), name
