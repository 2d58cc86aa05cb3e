"""Flagger model families (port of ``katsdpsigproc_tpu.models``)."""

from . import rfi  # noqa: F401

__all__ = ["rfi"]
