"""One module per kind of cell, found by the `kind` in the cell's file
(portbench/workloads/<cell>.json): portbench/cells/<kind>.py. Each gives

- run(cell, seed, seconds, tracer, device, cache_dir, t_start) -> dict
  with "log" (generator.Log), "peak" (bytes) and "checks"
  (judge.with_limits), beside what its metric readers read;
- controls(cell, seed, device, program) -> {name: numbers}: the readings
  that the limits of `correct` are set from (portbench/control.py).

A new model family, or a new kind of work, is a module here with its
plain reference in portbench/reference/, and no edit elsewhere.
"""
