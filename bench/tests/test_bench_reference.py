"""The plain reference against the program at tiny widths, and the
control: the reference in TF32 in the program's place fails the cell's
limits, as each fault a training cell can have does.

The tiny cells (``conftest.TINY``) cut the real cells' widths and keep
their graphs, periods, optimizers and limits.  A ``cuda`` test repeats
the control with the card's own TF32 where a card is present.
"""
import pytest
import torch

from bench import harness, judge, spec
from bench.reference import common

from bench_tiny import TINY

CELLS = sorted(TINY)


@pytest.fixture(scope="module")
def readings(tiny_root):
    """Per tiny cell and seed: the program's, the f32 reference's, the
    control's and the faults' readings."""
    out = {}
    for name in CELLS:
        cell = spec.load(name, root=tiny_root)
        for seed in (3, 2 ** 31 + 17):
            s = harness.Setup(cell, seed, "cpu")
            st = s.stream(s.check_steps)
            prog, _ = harness.program_readings(s, st)
            out[name, seed] = {
                "cell": cell, "program": prog,
                "f32": harness.reference_readings(s, st),
                "tf32": harness.reference_readings(s, st, "tf32"),
                "half_batch": harness.reference_readings(
                    s, st, fault="half_batch"),
                "no_exchange": harness.reference_readings(
                    s, st, fault="no_exchange")}
    return out


def _cases():
    return [(n, s) for n in CELLS for s in (3, 2 ** 31 + 17)]


@pytest.mark.parametrize("name,seed", _cases())
def test_program_agrees_with_the_reference(readings, name, seed):
    r = readings[name, seed]
    nums = judge.numbers(r["program"], r["f32"])
    assert max(nums.values()) < 1e-6, nums
    ok, checks = judge.judge(nums, r["cell"].limits)
    assert ok, checks


@pytest.mark.parametrize("name,seed", _cases())
@pytest.mark.parametrize("case", ["tf32", "half_batch", "no_exchange"])
def test_control_and_faults_fail_the_limits(readings, name, seed, case):
    r = readings[name, seed]
    ok, checks = judge.judge(judge.numbers(r[case], r["f32"]),
                             r["cell"].limits)
    assert not ok, checks


def test_state_left_unchanged_reads_one(readings):
    r = readings[CELLS[0], 3]
    still = dict(r["f32"], change={n: 0.0 for n in r["f32"]["change"]})
    assert judge.numbers(still, r["f32"])["change_gap"] == pytest.approx(1)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12])
    got = common.round_tf32(x)
    # 10 bits after the point: 1 + 2^-11 ties to even (1), 1 + 3·2^-11
    # ties up to 1 + 2^-9
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


@pytest.mark.cuda
def test_control_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = spec.load(CELLS[0], root=tiny_root)
    harness.f32_only()
    s = harness.Setup(cell, 5, "cuda")
    st = s.stream(s.check_steps)
    prog, _ = harness.program_readings(s, st)
    ref = harness.reference_readings(s, st)
    assert judge.judge(judge.numbers(prog, ref), cell.limits)[0]
    ctl = harness.reference_readings(s, st, "tf32")
    assert not judge.judge(judge.numbers(ctl, ref), cell.limits)[0]
