"""Primitive operations (port of ``katsdpsigproc_tpu.ops``; rank only so far)."""

from . import rank  # noqa: F401

__all__ = ["rank"]
