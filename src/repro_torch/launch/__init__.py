"""The sharded runtime of the port: the worker mesh over
``torch.distributed`` (:mod:`repro_torch.launch.mesh`), spawning ranks
(:mod:`repro_torch.launch.spawn`), ``build_train``/``TrainPack``
(:mod:`repro_torch.launch.runtime`) and the training launcher
(``python -m repro_torch.launch.train``).  Importing any of these creates
no process group and touches no device."""
