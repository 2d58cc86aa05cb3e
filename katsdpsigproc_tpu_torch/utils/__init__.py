"""Support code for the port: nvcc builds and ctypes loading of the
kernels, device contexts, the tuning table, shapes, region copies,
profiling, the asyncio resource layer and pinned float32 arithmetic.

Port of ``katsdpsigproc_tpu.utils``.
"""

from . import (backend, kernels, numerics, profiling, regions, resource,  # noqa: F401
               shapes, tune)

__all__ = ["backend", "kernels", "numerics", "profiling", "regions", "resource", "shapes",
           "tune"]
