"""Checkpoints of the port: ``save``/``restore``/``latest_step``
(:mod:`repro_torch.checkpoint.checkpoint`), and the elastic K→K′ restore
and in-fleet revival (:mod:`repro_torch.checkpoint.elastic`)."""
from repro_torch.checkpoint.checkpoint import latest_step, restore, save
from repro_torch.checkpoint.elastic import (donor_map, pick_donor,
                                            repartition, restore_elastic,
                                            warm_start_worker)

__all__ = ["save", "restore", "latest_step", "donor_map", "pick_donor",
           "repartition", "restore_elastic", "warm_start_worker"]
