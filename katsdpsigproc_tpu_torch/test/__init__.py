"""Public test utilities for downstream packages.

Port of ``katsdpsigproc_tpu/test/__init__.py``: the test decorators ship
as an importable module (:mod:`.test_accel`) so that downstream packages
can decorate their own device tests.
"""
