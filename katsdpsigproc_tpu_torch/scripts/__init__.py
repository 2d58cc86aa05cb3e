"""Command-line probes of the port on the card.

Each runs as ``python -m katsdpsigproc_tpu_torch.scripts.<name>`` and
needs a CUDA device.  They port the TPU probes of ``scripts/`` under the
same names, on the main path's dump by default: the stage probes of K1
and the cost probes ``prim_cost`` (K8) and ``roofline_skeleton`` (K10).
``k1_ab`` has no TPU counterpart: it times K1 in its run layout against
K1 in the strided layout (probe ``full``).
"""
