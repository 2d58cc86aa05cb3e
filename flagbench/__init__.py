"""The benchmark of the PyTorch and CUDA port (``katsdpsigproc_tpu_torch``).

The yardstick: the cells' traffic and data (``traffic/``, :mod:`.data`),
the loops that drive the program, one file each (``loops/``), the
configurations (``configs/``), the plain reference (:mod:`.reference`),
the peaks and least work of each kernel (:mod:`.counts`) and a reader for
each per-layer metric (``metrics/``).  From the program it takes only the
system under test and its counters and kernel names.  Nothing here imports
JAX or the JAX package.  See ``README.md``.
"""
