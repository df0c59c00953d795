"""The dry run on meta over a fake process group
(``repro_torch.launch.dryrun``, ``analytic``, ``roofline``) and the kernel
wrappers' meta route: the port's ``analytic_cost`` equals the reference's
for every assigned arch × shape × kind; ``model_flops`` and
``roofline_terms`` with the ``HW`` passed in; a smoke config's step on an
8-rank fake group (in a spawned process) hands ``isend`` exactly its
accounted bytes; the analytic fields ``run_one`` writes for OLMo-1B ×
train_4k under ``--hier`` equal the reference's committed records on both
meshes (computed by the function ``run_one`` fills them with, no meta step
at 256 or 512 ranks here); and a meta tensor reaches each wrapper's plain
version, where an unsupported device still raises."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as r_get_config  # noqa: E402
from repro.configs.registry import long_ctx_variant as r_long  # noqa: E402
from repro.configs.shapes import SHAPES as R_SHAPES  # noqa: E402
from repro.launch.analytic import analytic_cost as r_analytic  # noqa: E402
from repro.launch.hlo_analysis import model_flops as r_model_flops  # noqa
from repro.launch.hlo_analysis import roofline_terms as r_roofline  # noqa
from repro.launch.mesh import HW as R_HW  # noqa: E402
from repro_torch.configs.registry import (ASSIGNED, get_config,  # noqa: E402
                                          get_smoke_config,
                                          long_ctx_variant)
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.analytic import analytic_cost  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402
from repro_torch.launch.roofline import (model_flops,  # noqa: E402
                                         roofline_terms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_analytic_cost_equals_the_reference(arch):
    n = 0
    for name, shape in SHAPES.items():
        m, rm = get_config(arch).model, r_get_config(arch).model
        if name == "long_500k":
            m, rm = long_ctx_variant(m), r_long(rm)
        for kind in ("train", "prefill", "decode"):
            for (p, chips, workers, remat) in ((4, 256, 16, "full"),
                                               (8, 512, 2, "none")):
                got = analytic_cost(m, shape, kind, p, chips, workers, remat)
                want = r_analytic(rm, R_SHAPES[name], kind, p, chips,
                                  workers, remat)
                assert set(got) == set(want)
                for k in want:
                    assert got[k] == pytest.approx(want[k], rel=1e-12,
                                                   abs=0.0), (name, kind, k)
                n += 1
    assert n == 4 * 3 * 2


def test_roofline_terms_and_model_flops():
    # with the reference's HW passed in, the reference's terms
    for args in ((1.3e14, 2e10, 4.6e11), (1e12, 8e11, 1e6), (0.0, 1.0, 0.0)):
        assert roofline_terms(*args, hw=R_HW) == r_roofline(*args)
    # the port's own HW: the H100 SXM5's data-sheet peaks
    t = roofline_terms(989.4e12, 3.35e12, 450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.ICI_BW, HW.HBM_BYTES) == \
        (989.4e12, 3.35e12, 450e9, 80e9)
    assert roofline_terms(1.0, 1e3, 1.0)["dominant"] == "memory"
    for kind in ("train", "prefill", "decode"):
        assert model_flops(1.2e9, 4096.0, kind) == \
            r_model_flops(1.2e9, 4096.0, kind)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_hier_analytic_fields_equal_the_committed_reference(mesh):
    multi = mesh == "2x16x16"
    run = dryrun.hier_overrides(multi)(get_config("olmo-1b"))
    got = dryrun.analytic_fields(run, run.model, SHAPES["train_4k"], multi)
    name = f"olmo-1b__train_4k__{mesh}__hier.json"
    with open(os.path.join(REPO, "artifacts", "dryrun", name)) as f:
        ref = json.load(f)
    with open(os.path.join(REPO, "artifacts", "dryrun_torch", name)) as f:
        ours = json.load(f)
    for k in ("tokens_per_call", "flops_per_device", "bytes_per_device",
              "model_flops", "hlo_total_flops", "n_chips", "n_workers", "p",
              "profile"):
        assert got[k] == ref[k] == ours[k], k
    # the recorded wire: the gossip's sends equal the reference HLO's
    assert ours["collective_result_bytes"]["collective-permute"] == \
        ref["collective_result_bytes"]["collective-permute"]
    assert ours["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]


@pytest.mark.parametrize("arch,sizes,names,model_axis", [
    ("olmo-1b", (4,), ("data",), 2),
    ("mixtral-8x7b", (2, 2), ("pod", "data"), 2),
])
def test_smoke_step_on_a_fake_group_ships_its_accounted_bytes(
        arch, sizes, names, model_axis):
    """A smoke config's round on meta, rank 0 of a fake group of 8 ranks
    (profile A: 4 workers × TP 2; profile B: 2 pods × FSDP 2 × TP 2), in
    a process of its own: the bytes the recorder counts for ``isend``
    equal the optimizer's ``bytes_per_comm_round`` of the rank's tree,
    and the memory fields are filled."""
    run = get_smoke_config(arch)
    shape = InputShape("t", 16, 8, "train")
    got = dryrun.run_in_process(dryrun.meta_step, run, run.model, shape,
                                sizes, names, model_axis)
    assert got["collective_wire_bytes"]["collective-permute"] == \
        got["bytes_per_comm_round"] > 0
    mem = got["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["output_bytes"] > 0
    assert got["n_workers"] == (4 if run.parallel.profile == "A" else 2)
    if run.parallel.profile == "B":
        assert "all-gather" in got["collective_counts"]


# ------------------------------------------------------- the meta route
def _mat(rows=256, device="meta", dtype=torch.float32, cols=1024):
    return torch.empty((rows, cols), dtype=dtype, device=device)


def _calls():
    """Each wrapper's call on meta operands, its module and the name of
    the plain version it imports."""
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import momentum as mo
    from repro_torch.kernels import qsgd_quant as qq
    from repro_torch.kernels import row_gather as rg
    from repro_torch.kernels import sign_compress as sc
    from repro_torch.kernels import topk_select as tk
    lr = torch.empty((), device="meta")
    counts = torch.empty((256, 1), device="meta")
    idx = torch.empty((2, 8), dtype=torch.int32, device="meta")
    x3 = torch.empty((2, 128, 1024), device="meta")
    return {
        "momentum_update": (mo, "momentum_update_ref", lambda: mo.
                            momentum_update(_mat(), _mat(), _mat(), lr,
                                            mu=0.9, inplace=True)),
        "gossip_mix": (gm, "gossip_mix_ref", lambda: gm.gossip_mix(
            (_mat(), _mat()), weights=(0.5, 0.5))),
        "gossip_mix_shifted": (gm, "gossip_shift_ref", lambda: gm.
                               gossip_mix_shifted(x3, grid=(2,), axis=0,
                                                  shifts=(0, 1),
                                                  weights=(0.5, 0.5))),
        "sign_pack": (sc, "sign_pack_rows_ref",
                      lambda: sc.sign_pack(_mat(), counts)),
        "sign_unpack": (sc, "sign_unpack_ref", lambda: sc.sign_unpack(
            _mat(dtype=torch.uint8, cols=128), counts)),
        "qsgd_quant": (qq, "qsgd_rows_ref",
                       lambda: qq.qsgd_quant(_mat(), levels=7)),
        "qsgd_dequant": (qq, "qsgd_rows_unpack_ref", lambda: qq.qsgd_dequant(
            _mat(dtype=torch.uint8, cols=512), counts, levels=7)),
        "topk_select": (tk, "topk_rows_ref",
                        lambda: tk.topk_select(_mat(), counts,
                                               fraction=0.1)),
        "topk_scatter": (tk, "topk_rows_unpack_ref", lambda: tk.topk_scatter(
            _mat(dtype=torch.int32, cols=103), _mat(cols=103))),
        "row_gather": (rg, "row_gather_ref",
                       lambda: rg.row_gather(x3, idx)),
        "row_scatter": (rg, "row_scatter_ref", lambda: rg.row_scatter(
            idx, torch.empty((2, 8, 1024), device="meta"), rows=128)),
    }


@pytest.mark.parametrize("name", list(_calls()))
def test_meta_tensor_reaches_the_plain_version(name, monkeypatch):
    mod, ref, call = _calls()[name]
    seen = []
    inner = getattr(mod, ref)

    def counted(*a, **k):
        seen.append(name)
        return inner(*a, **k)
    monkeypatch.setattr(mod, ref, counted)
    out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert seen == [name]
    assert all(o.device.type == "meta" for o in outs)


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device and holds no data (every op on it
    raises)."""

    @staticmethod
    def __new__(cls, shape, dtype, device):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device=device)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"no data behind {func}")


def test_unsupported_device_raises_and_cuda_never_falls_back():
    from repro_torch.kernels import sign_compress as sc
    from repro_torch.kernels._check import plain_route
    xpu = _Elsewhere((256, 1024), torch.float32, torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        sc.sign_pack(xpu, _Elsewhere((256, 1), torch.float32,
                                     torch.device("xpu")))
    # a CUDA tensor takes the kernel route: it launches or raises (here,
    # with no card and no nvcc, it raises), never the plain version
    cuda = _Elsewhere((256, 1024), torch.float32, torch.device("cuda"))
    assert not plain_route(cuda)
    assert plain_route(_mat()) and plain_route(_mat(device="cpu"))
    with pytest.raises(RuntimeError):
        sc.sign_pack(cuda, _Elsewhere((256, 1), torch.float32,
                                      torch.device("cuda")))
