"""Each CUDA library's C interface against its Python binding, on the CPU.

A library under ``katsdpsigproc_tpu_torch/csrc/`` is loaded with ctypes by
one ``_library`` function, which declares the argument and result types of
the entries it calls.  Here that function runs against a stand-in for the
loaded library that records every entry it is asked for, and the names it
declares must be the ``extern "C"`` entries the source defines: an entry
nothing declares (a design no wrapper launches any more) or a declaration
of an entry the source lacks fails.  No nvcc and no card are needed.
"""

import re
import types

import pytest

from katsdpsigproc_tpu_torch.examples import triple
from katsdpsigproc_tpu_torch.models.rfi import flagger_probe, fused_flagger, twodflag
from katsdpsigproc_tpu_torch.ops import percentile, transpose
from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton
from katsdpsigproc_tpu_torch.utils import kernels

# Library (csrc/<name>.cu) -> its binding, called past its cache.
BINDINGS = {
    "box_filter": lambda: twodflag._box_library.__wrapped__(),
    "examples": lambda: triple._library.__wrapped__(),
    "flagger_probe": lambda: flagger_probe._library.__wrapped__(13),
    "fused_flagger": lambda: fused_flagger._library.__wrapped__(13),
    "masked_median": lambda: twodflag._mm_library.__wrapped__(),
    "percentile": lambda: percentile._library.__wrapped__(),
    "prim_cost": lambda: prim_cost._library.__wrapped__(),
    "roofline_skeleton": lambda: roofline_skeleton._library.__wrapped__(13),
    "sum_threshold": lambda: twodflag._st_library.__wrapped__(),
    "transpose": lambda: transpose._library.__wrapped__(),
}


class _RecordingLibrary:
    """Hands out an entry for every name asked for, and keeps the names."""

    def __init__(self):
        self.names = set()

    def __getattr__(self, name):
        self.names.add(name)
        entry = types.SimpleNamespace()
        object.__setattr__(self, name, entry)
        return entry


def c_entries(source: str) -> set:
    """The functions defined at the top level of the source's ``extern "C"`` blocks."""
    names = set()
    for block in re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"', source, re.M | re.S):
        names |= set(re.findall(r"^[A-Za-z][\w \*]*?\b(\w+)\(", block, re.M))
    return names


def test_every_library_has_a_binding():
    assert set(BINDINGS) == {p.stem for p in kernels.CSRC_DIR.glob("*.cu")}


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_binding_declares_each_c_entry(name, monkeypatch):
    loaded = []

    def load(lib_name, sources, headers):
        assert (lib_name, list(sources)) == (name, [f"{name}.cu"])
        loaded.append(_RecordingLibrary())
        return loaded[-1]

    monkeypatch.setattr(kernels, "load", load)
    BINDINGS[name]()
    declared = loaded[0].names
    defined = c_entries((kernels.CSRC_DIR / f"{name}.cu").read_text())
    assert defined, "no extern \"C\" entry found"
    assert declared - defined == set(), "declared in the binding, not defined in the source"
    assert defined - declared == set(), "defined in the source, declared by no binding"
