"""The benchmark of tpu_pathtracer_torch: one cell a run (``run.py``), driven
by ``BENCHMARK.json`` and the data files beside this package."""
