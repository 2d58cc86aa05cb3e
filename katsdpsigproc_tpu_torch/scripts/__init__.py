"""Command-line probes of the port on the card.

Each runs as ``python -m katsdpsigproc_tpu_torch.scripts.<name>`` and
needs a CUDA device.  They port the TPU probes of ``scripts/`` under the
same names, on the main path's dump by default.
"""
