"""The sharded runtime of the port: the worker mesh over
``torch.distributed`` (:mod:`repro_torch.launch.mesh`), spawning ranks
(:mod:`repro_torch.launch.spawn`), ``build_train``/``TrainPack`` and
``build_serve``/``ServePack`` (:mod:`repro_torch.launch.runtime`), the
training launcher (``python -m repro_torch.launch.train``) and the
serving launcher (``python -m repro_torch.launch.serve``).  Importing any of these creates
no process group and touches no device."""
