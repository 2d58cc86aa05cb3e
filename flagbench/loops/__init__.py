"""The ways a cell drives the program, one file each: ``loops/<loop>.py``.

A traffic mix names its loop (``"loop": "resident"``), and :func:`load`
finds the file of that name and takes the one :class:`Loop` subclass it
defines.  A loop owns everything that belongs to the shape of what it
drives: the set-up before its inputs, its inputs made from the seed, the
visibilities a dump holds, the reference flags of a dump and any checks
beyond the harness's own.  The harness calls those hooks and names no
flagger, kernel or reference of its own, so a cell of another shape is a
new loop file, and a new reference file if it needs one.

``resident`` and ``stream`` drive the 1-D flagger on (channels, rows, 2)
dumps; ``stream`` takes the 1-D hooks from ``resident``.
"""

import importlib
import random
from pathlib import Path
from typing import List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A reservoir of `size` (dump, ring slot, flags) drawn uniformly from the seed."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self.rng = random.Random(seed)
        self.items: List[Tuple[int, int, object]] = []
        self.seen = 0

    def offer(self, dump: int, slot: int, flags) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((dump, slot, flags))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = (dump, slot, flags)


class Loop:
    """What the harness asks of a loop, in the order it asks.

    A run calls :meth:`prepare` once, before anything of the cell is made;
    then :meth:`n_vis` and :meth:`inputs` on the cell (a namespace holding
    ``config``, ``traffic`` and ``device``); then builds the loop on the
    cell, :meth:`warm` s it and runs its :meth:`window`.  After the window
    each sampled dump's flags, through :meth:`flags_on_device`, are
    compared with :meth:`reference_flags` of its ring slot, and
    :meth:`checks` adds the loop's own numbers to the harness's.
    """

    @staticmethod
    def prepare(config: dict) -> Optional[Tuple[str, str]]:
        """Set-up before the inputs: None, or (the stage's name, a note for standard error)."""
        return None

    @staticmethod
    def n_vis(config: dict) -> int:
        """The visibilities one dump holds: what ``gvis_per_s`` counts for each dump flagged."""
        raise NotImplementedError

    @staticmethod
    def inputs(cell, seed: int) -> None:
        """Make the cell's inputs from `seed`, as attributes of `cell`."""
        raise NotImplementedError

    def __init__(self, cell) -> None:
        self.cell = cell

    def warm(self) -> None:
        """Run every shape the window will use, so that nothing builds inside it."""
        raise NotImplementedError

    def window(self, seconds: float, tracer, sample: Sample) -> dict:
        """Dumps back to back for at least `seconds`; offers each dump's flags to `sample`.

        Returns the counters: ``dumps``, ``window_s``, ``latency_s`` (one a
        dump), ``missing`` (dumps whose flags never came back), and any the
        loop's checks and the per-layer readers read.
        """
        raise NotImplementedError

    def reference_flags(self, slot: int, dtype=torch.float32) -> torch.Tensor:
        """The plain reference's flags of ring slot `slot`, computed in `dtype`."""
        raise NotImplementedError

    def flags_on_device(self, flags) -> torch.Tensor:
        """A sampled dump's flags, as the reference gives them."""
        raise NotImplementedError

    def checks(self, counters: dict) -> dict:
        """The loop's own numbers compared, each {"value": ..., "limit": ...}."""
        return {}


def load(name: str) -> type:
    """The loop class of ``loops/<name>.py``: the one :class:`Loop` subclass that file defines."""
    path = HERE / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise FileNotFoundError(f"the mix names loop {name!r}, but there is no loop file {path}")
    module = importlib.import_module(f"{__name__}.{name}")
    found = [obj for obj in vars(module).values()
             if isinstance(obj, type) and issubclass(obj, Loop)
             and obj.__module__ == module.__name__]
    if len(found) != 1:
        raise TypeError(f"{path} defines {len(found)} Loop classes; a loop file defines one")
    return found[0]
