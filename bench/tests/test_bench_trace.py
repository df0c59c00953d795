"""The trace reduction and the per-layer readers, on a synthetic chrome
trace (``trace_small.json``): a 1,000 us window holding ten device
events, two of which overlap, one memcpy, and one kernel after the
window; one of the two products is launched inside the exchange's
span."""
from pathlib import Path

import pytest

from bench import tracing, yardstick
from bench.harness import Traced
from bench.spec import ROOT, reader

FIXTURE = Path(__file__).with_name("trace_small.json")
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}


@pytest.fixture(scope="module")
def events():
    return tracing.load(FIXTURE)


@pytest.fixture(scope="module")
def traced(events):
    lo, hi = tracing.window(events)
    dev = tracing.device_events(events, lo, hi)
    model = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
             "d_ff": 16, "vocab": 32, "gated_mlp": False,
             "pattern": [{"mixer": "attn", "ffn": "dense"}],
             "compute_dtype": "float32"}
    return Traced(dev=dev, window_s=(hi - lo) * 1e-6,
                  busy_s=tracing.busy_us(dev, lo, hi) * 1e-6, rounds=2,
                  tokens=1000, seq=4, workers=2, elems=1000, blocks=1,
                  model=model, peaks=PEAKS, ms_by_kind=tracing.ms_by_kind(dev))


def test_window_is_the_host_span(events):
    assert tracing.window(events) == (1000, 2000)


def test_device_events_inside_the_window(events):
    dev = tracing.device_events(events, 1000, 2000)
    assert len(dev) == 9
    assert all(1000 <= d[2] < 2000 for d in dev)


def test_busy_is_a_union_not_a_sum(events):
    dev = tracing.device_events(events, 1000, 2000)
    assert sum(d[3] - d[2] for d in dev) == 780
    assert tracing.busy_us(dev, 1000, 2000) == 680


def test_exchange_by_the_launching_call(events):
    dev = tracing.device_events(events, 1000, 2000)
    ex = {d[0] for d in dev if d[4]}
    # the xmma product's cuLaunchKernel lies in the exchange's span; the
    # sgemm's cudaLaunchKernel and the events without a launch do not
    assert len(ex) == 1 and next(iter(ex)).startswith("sm90_xmma_gemm")


def test_gaps_and_what_the_host_did(events):
    dev = tracing.device_events(events, 1000, 2000)
    assert sum(e - s for s, e in tracing.gaps(dev, 1000, 2000)) == 320
    brk = tracing.breakdown(events, dev, 1000, 2000)
    idle = dict(brk["idle_gaps"])
    # at 1,000 us the window's span began after aten::zeros: innermost
    assert idle == pytest.approx({"bench.window": 270e-6,
                                  "aten::copy_": 50e-6})
    assert brk["device_ops"][0] == ["ampere_sgemm_128x64_nn",
                                    pytest.approx(300e-6)]
    assert len(brk["device_ops"]) == 9


@pytest.mark.parametrize("name,cat,want", [
    ("void momentum_inplace_kernel(float4*)", "kernel", "momentum"),
    ("void gossip_mix_kernel<32>(Mix<32>, float4*)", "kernel", "gossip"),
    ("void sign_unpack_kernel(unsigned int const*)", "kernel", "sign_codec"),
    ("ampere_sgemm_128x64_nn", "kernel", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nt_align1>",
     "kernel", "gemm"),
    ("void splitKreduce_kernel<32, 16, int, float>", "kernel", "gemm"),
    ("void at::native::direct_copy_kernel_cuda", "kernel", "copy_fill"),
    ("Memset (Device)", "gpu_memset", "copy_fill"),
    ("void at::native::reduce_kernel<512, 1>", "kernel", "other"),
])
def test_kind(name, cat, want):
    assert tracing.kind(name, cat) == want


@pytest.mark.parametrize("name,want", [
    ("void gemv2T_kernel_val<int, int, float, float, float, 128, 16>",
     "exchange_gemm"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", "exchange_gemm"),
    ("void momentum_inplace_kernel(float4*)", "momentum"),
    ("void gossip_mix_kernel<32>(Mix<32>, float4*)", "gossip"),
    ("void at::native::direct_copy_kernel_cuda", "copy_fill"),
])
def test_kind_in_the_exchange(name, want):
    assert tracing.kind(name, "kernel", exchange=True) == want


def test_ms_by_kind(traced):
    assert traced.ms_by_kind == pytest.approx(
        {"momentum": 0.1, "gemm": 0.3, "exchange_gemm": 0.2,
         "copy_fill": 0.07, "gossip": 0.05, "sign_codec": 0.02,
         "other": 0.04})


def _cell():
    class Cell:
        root = ROOT
    return Cell()


def test_readers(traced):
    read = {name: reader(_cell(), name)
            for name in ("device_idle_pct", "grad_gemm_ms_per_round",
                         "copy_fill_ms_per_round", "launches_per_round",
                         "momentum_roofline", "gossip_roofline",
                         "sign_codec_roofline", "step_mfu_pct",
                         "consensus_gemm_ms_per_round")}
    assert read["device_idle_pct"](traced) == pytest.approx(32.0)
    # the sgemm's 0.3 ms over 2 rounds; the exchange's product is not
    # the gradient's
    assert read["grad_gemm_ms_per_round"](traced) == pytest.approx(0.15)
    assert read["consensus_gemm_ms_per_round"](traced) == pytest.approx(0.1)
    assert read["copy_fill_ms_per_round"](traced) == pytest.approx(0.035)
    assert read["launches_per_round"](traced) == 4.0     # 8 kernels / 2
    mom = 5 * 2 * 1000 * 4 / 3.35e12 * 1e3
    assert read["momentum_roofline"](traced) == pytest.approx(
        100 * mom / 0.1)
    gos = 2 * 2 * 1000 * 4 / 3.35e12 * 1e3
    assert read["gossip_roofline"](traced) == pytest.approx(
        100 * gos / 0.05)
    sign = yardstick.sign_codec_bytes(2, 1000, 1) / 3.35e12 * 1e3
    assert read["sign_codec_roofline"](traced) == pytest.approx(
        100 * sign / 0.02)
    flops = yardstick.model_flops_per_token(traced.model, 4) * 1000
    assert read["step_mfu_pct"](traced) == pytest.approx(
        100 * flops / 1e-3 / 67e12)


def test_a_reader_with_nothing_to_read_returns_none(traced):
    empty = Traced(**{**traced.__dict__, "dev": [], "ms_by_kind": {}})
    for name in ("grad_gemm_ms_per_round", "consensus_gemm_ms_per_round",
                 "momentum_roofline",
                 "gossip_roofline", "sign_codec_roofline",
                 "launches_per_round"):
        assert reader(_cell(), name)(empty) is None


def test_exchange_spans_each_round_and_come_off(tiny_root):
    from torch.profiler import ProfilerActivity, profile

    from bench import harness, spec, weights
    cell = spec.load("tiny-dense.pd", root=tiny_root)
    s = harness.Setup(cell, 3, "cpu")
    x = weights.stack(s.x0(), cell.traffic["workers"])
    with s.prog.exchange_spans(tracing.EXCHANGE), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        s.prog.train(x, s.stream(2 * s.p).feed(0), 2 * s.p)
    assert sum(e.name == tracing.EXCHANGE for e in prof.events()) == 2
    assert "comm_round_mat" not in vars(s.prog.opt)
