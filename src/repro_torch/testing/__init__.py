"""Test substrates of the port.

``repro_torch.testing.chaos`` is the fault-injection layer of elastic
membership: seeded kill / revive / straggle scripts, a dense driver that
runs the fused round under churn and records survivor metrics, and a
wire-byte oracle that derives the shipped bytes apart from the
optimizers' accounting.
"""
from repro_torch.testing.chaos import (ChaosEvent, ChaosRun, chaos_script,
                                       check_round_matrix, membership_for,
                                       oracle_fleet_bytes, revivals_by_round,
                                       run_dense_chaos)

__all__ = ["ChaosEvent", "ChaosRun", "chaos_script", "check_round_matrix",
           "membership_for", "oracle_fleet_bytes", "revivals_by_round",
           "run_dense_chaos"]
