"""Deprecated alias package (port of ``katsdpsigproc_tpu/asyncio/__init__.py``)."""
