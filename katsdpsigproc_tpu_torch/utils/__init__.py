"""Support code for the port: nvcc builds and ctypes loading of the
kernels, device contexts, the tuning table, shapes and pinned float32
arithmetic."""
