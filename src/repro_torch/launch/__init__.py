"""The sharded runtime of the port: the worker mesh over
``torch.distributed`` (:mod:`repro_torch.launch.mesh`), spawning ranks
(:mod:`repro_torch.launch.spawn`), ``build_train``/``TrainPack`` and
``build_serve``/``ServePack`` (:mod:`repro_torch.launch.runtime`), the
training launcher (``python -m repro_torch.launch.train``) and the
serving launcher (``python -m repro_torch.launch.serve``), and the dry run
of production configurations on meta tensors over a fake process group
(:mod:`repro_torch.launch.dryrun`, with ``analytic``, ``roofline``,
``diagnose`` and ``hillclimb``).  Importing any of these creates no
process group and touches no device."""
