"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON line.  Everything here is found by name:

* ``configs/<name>.json``: a model configuration as it is run;
* ``traffic/<name>.json``: a traffic mix (optimizer, graph, period,
  sequence and batch a worker, token stream), read by ``streams.py``;
* ``limits/<cell>.json``: the limits of a cell's correctness numbers;
* ``metrics/<name>.py``: the reader of one per-layer metric, which
  takes the traced window as :class:`bench.harness.Traced`: its device
  events, the whole trace's events with the program's spans (read
  through ``spans.py``), the program's counters' changes over the window
  (:meth:`bench.program.Program.counters`), and the work the window held;
* ``reference/<name>.py``: the plain f32 reference the run is judged by.

The yardstick (``yardstick.py``: operations and bytes from shapes, for
every layer kind a configuration can state;
``peaks.json``; ``tracing.py``: the trace reduction; ``judge.py``: the
comparison that decides ``correct``) lives here and nowhere in the
program.  Only ``program.py`` imports ``repro_torch``; nothing here
imports JAX or the JAX package.
"""
