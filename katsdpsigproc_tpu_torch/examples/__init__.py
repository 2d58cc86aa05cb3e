"""The tutorial examples, ported from ``doc/examples/``.

Each runs as a module and asserts its result as its JAX twin does::

    python -m katsdpsigproc_tpu_torch.examples.<name> [--device cpu]

``hello_device``, ``triple_fn``, ``triple`` (the CUDA kernel K7),
``triple_pallas`` (the Triton kernel K6), ``triple_op``, ``fill_reduce``,
``resource_pipeline`` (streaming ingest through the fused flagger) and
``sharded_flagger`` (the flaggers of ``parallel`` over several ranks,
``--world-size``).

An example runs on the card and raises without one, unless it is asked
for the CPU (``--device cpu``), where each kernel takes its plain PyTorch
version.  Nothing here runs when the package is imported.
"""

import argparse
from typing import Optional, Sequence

import torch

from ..utils import backend


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's command line: ``--device`` (``cuda``, the default, or ``cpu``)."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default %(default)s; cpu runs the plain versions)")
    return ap


def context(device: str) -> backend.DeviceContext:
    """A context on `device`; raises ``SystemExit`` for ``cuda`` without a card."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run this example on the CPU")
    return backend.create_some_context(device_filter=lambda d: d.type == device)


def parse(doc: str, argv: Optional[Sequence[str]] = None) -> backend.DeviceContext:
    """Parse an example's only option and return its context."""
    return context(parser(doc).parse_args(argv).device)
