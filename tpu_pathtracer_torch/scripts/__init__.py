"""Kernel-research tools of the port: the counterparts of the reference's
``scripts/`` files that hold kernels.

* :mod:`.experimental_sweep`: the candidate-sweep pair (leaf-AABB count and
  the targeted one-leaf Moller-Trumbore test);
* :mod:`.perf_launch`: the launch-cost probe
  (``python -m tpu_pathtracer_torch.scripts.perf_launch``);
* :mod:`.perf_ophit_probe`: the row-test cost probe
  (``python -m tpu_pathtracer_torch.scripts.perf_ophit_probe``).

None of them is on a frame's path.  Each kernel (``csrc/candidate_sweep.cu``,
``csrc/probes.cu``) has a plain torch version beside its wrapper; a wrapper
takes the plain version only for CPU tensors and launches or raises on CUDA
tensors, counting its launches in ``.launches``.  The probe and the count
share :mod:`.dense_march`'s launch shape; their first port's kernels
(``csrc/march_v1.cu``) stay as yardsticks, ``rowtest_probe_v1`` and
``sweep_count_v1``.
"""
