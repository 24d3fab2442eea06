"""The benchmark of the PyTorch/CUDA port (``bipedal_control_tpu_torch``).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once; see its
docstring.  Everything that measures lives here: the traffic generators,
the drivers of each kind of cell, the reduction of a profiler trace, the
per-layer metrics' readers, the kernels' operation and byte counts, the
frozen plain reference (``benchmark/reference``) and the comparison that
decides ``correct``.  The program under test is the port; the JAX package
is never imported.
"""
