"""Checkpoints of the port.  Only the in-fleet revival of elastic
membership is ported (:mod:`repro_torch.checkpoint.elastic`); saving,
restoring and the K→K′ re-partition are ROADMAP queue A item 12."""
from repro_torch.checkpoint.elastic import pick_donor, warm_start_worker

__all__ = ["pick_donor", "warm_start_worker"]
