"""One op program across a topology schedule
(``repro_torch.analysis.retrace``), as ``tests/test_analysis_retrace.py:
9-29`` holds the reference's one compilation: a full one-peer cycle and a
mid-cycle resume run one program, the counter tells programs apart, and a
round that branches on the host by its round index is caught."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import round_check as rc  # noqa: E402
from repro_torch.analysis.retrace import (OpTraceCounter,  # noqa: E402
                                          check_schedule_no_retrace)


def test_schedule_sweep_runs_one_program():
    assert check_schedule_no_retrace() == []


def test_counter_counts_distinct_programs():
    x = torch.zeros(4)
    cc = OpTraceCounter()
    for fn in (lambda: x + 1, lambda: x * 2, lambda: x + 1,
               lambda: torch.zeros(5) + 1):
        with cc.round():
            fn()
    assert len(cc.programs) == 4
    assert cc.count() == 3             # the same op on another shape counts
    assert cc.builds == 0


@pytest.mark.parametrize("schedule", ["one_peer_exp", "random_matching"])
def test_catches_host_branch_on_round_index(schedule):
    """The anti-pattern the guard exists for: a round whose ops depend on
    the round index read on the host (one program a parity)."""
    from repro_torch.core import PDSGDM, PDSGDMConfig
    from repro_torch.core.gossip import DenseComm
    from repro_torch.core.topology import make_schedule

    K, p = 8, 2
    sched = make_schedule(schedule, (K,))
    opt = PDSGDM(PDSGDMConfig(eta=0.05, mu=0.9, p=p),
                 DenseComm(sched, device="cpu"))
    params = rc.toy_params(K)
    state = opt.init(params)
    batches = rc.toy_batches(p, K)
    assert check_schedule_no_retrace(
        lambda: (lambda pr, st, b: opt.round(st, pr, rc.toy_grads_fn, b),
                 params, state, batches, sched.period)) == []

    def make_round():
        def bad_round(params, state, batches):
            r = int(state["step"]) // p          # the round on the host
            if r % 2:
                params = {k: v * 1.0 for k, v in params.items()}
            return opt.round(state, params, rc.toy_grads_fn, batches)
        return bad_round, params, state, batches, sched.period

    out = check_schedule_no_retrace(make_round)
    assert out and "expected exactly 1" in out[0]
