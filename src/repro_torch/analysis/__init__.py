"""Checks of the round contract on executed rounds (port of
``src/repro/analysis/``).

The port's speed rests on invariants that no single path checks: one
exchange per round at the round boundary, accounted bytes equal to shipped
bytes, no host sync and no float64 in a round, the momentum launch in
place, and one op program across a topology schedule.  The reference
checks them on traces and compiled HLO; the port runs one round and
records it:

collectives   — ``CommRecorder``: every collective a rank's mesh posts,
                with the reference's op names and ring-formula wire bytes
                (``src/repro/analysis/hlo_parse.py``)
round_check   — the op log of one executed round (a dispatch mode) and
                the checks on it (``jaxpr_check.py``)
wire_check    — in-place momentum, the collective allowlist and accounted
                ≡ shipped bytes on a sharded round (``hlo_check.py``)
retrace       — one op program across a schedule sweep and a resume
                (``retrace.py``)
astlint       — the source-level rules (``astlint.py``)
run           — the driver: ``python -m repro_torch.analysis.run``

Importing this package imports nothing else of the port, so the lint CLI
(``python -m repro_torch.analysis.astlint``) stays light.
"""
