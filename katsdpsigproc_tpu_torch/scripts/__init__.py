"""Command-line harnesses and probes of the port.

Each runs as ``python -m katsdpsigproc_tpu_torch.scripts.<name>``.  The
harnesses ``rfiflagtest`` (the 1-D and 2-D flaggers against their numpy
oracles), ``fftflagtest`` (the FFT path), ``transposetest`` (K5),
``percentiletest`` (K4), ``maskedsumtest`` and ``maskedsumabstest``, and
the offline tuner ``tune_all``, are copies of the reference's ``scripts/``
under the same names; they run on the card, or on the CPU with
``--device cpu``.  The probes need a CUDA device.  They port the TPU
probes of ``scripts/`` under the same names, on the main path's dump by
default: the stage probes of K1 and the cost probes ``prim_cost`` (K8)
and ``roofline_skeleton`` (K10).  ``k1_ab`` has no TPU counterpart: it
times K1 in its run layout against K1 in the strided layout (probe
``full``).
"""
