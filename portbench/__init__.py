"""The benchmark of ``operator_forge_torch``, the port to PyTorch and CUDA.

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, metric,
kernel class or cell's limits lives in a file of its own, found by name:

- ``configs/<config>.json``: the sizes as run, the source, departures,
  ``reduced`` and ``assumed``, and the ``architecture`` (``demo_block``
  where the key is absent);
- ``models/<architecture>.py``: the program the window drives, its weights
  from the seed, the order of the check's norms, and the model's and its
  kernel calls' operations and bytes (``models/__init__.py`` lists them);
- ``reference/<architecture>.py``: the plain reference the check compares
  with;
- ``traffic/<traffic>.json``: the entry the window drives (a closed loop of
  one client), the batch, the sequence, the token law and the pool
  (``run.ENTRIES`` reads them);
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
- ``kernels/<class>.json``: the device kernels of one class, by name;
- ``limits/<cell>.json``: each number compared for ``correct``, with its
  limit and the readings it was set from.

Nothing here imports ``jax`` or the JAX package; the reference imports
nothing of the program.  This module imports nothing heavy, so that a run's
clock starts before ``torch`` loads.
"""
