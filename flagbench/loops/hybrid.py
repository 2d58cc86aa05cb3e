"""The hybrid loop: the resident loop through katsdpsigproc's separate-pass flagger.

Each dump is flagged by the flagger that ``make_flagger_fn`` builds from
the configuration's ``flagger`` and ``flagger_fn`` (``engine="hybrid"``:
the background median as eager tensor code, its deviations written to
device memory, turned baseline-major, then MAD noise and SumThreshold in
K2, one slab of ``baseline_block`` rows at a time), called on the
channel-major (channels, rows, 2) dump itself.  Its (channels, rows)
flags are judged, turned, against :mod:`flagbench.reference`: the
separate-pass flagger gives the fused flagger's flags, so the 1-D
reference serves both.
"""

import torch

from .resident import Resident


class Hybrid(Resident):
    """The resident loop, each dump ``fn(vis)`` with ``fn`` built once from the configuration.

    ``prepare`` is the resident loop's: it loads K1's library, which K2
    shares.  Its checks replace ``k1_launch_gap`` with ``k2_launch_gap``:
    one K2 launch a slab, ``ceil(rows / baseline_block)`` a dump, from the
    program's counter ``fused_flagger.launches["madnz_threshold"]``.
    """

    @staticmethod
    def inputs(cell, seed: int) -> None:
        if cell.traffic["input_flags"] != "none":
            raise ValueError("the hybrid loop takes input_flags 'none'")
        Resident.inputs(cell, seed)

    def __init__(self, cell) -> None:
        from katsdpsigproc_tpu_torch.models.rfi import device

        super().__init__(cell)
        fl = cell.flagger
        fn_kw = cell.config["flagger_fn"]
        self.fn = device.make_flagger_fn(fl["width"], fl["n_sigma"], n_windows=fl["n_windows"],
                                         threshold_falloff=fl["falloff"],
                                         flag_value=fl["flag_value"], **fn_kw)
        rows, block = cell.config["rows"], fn_kw.get("baseline_block") or cell.config["rows"]
        self.slabs = -(-rows // block)

    def _call(self, i: int):
        return self.fn(self.ring[i % len(self.ring)])

    def window(self, seconds: float, tracer, sample) -> dict:
        k2 = self.ff.launches["madnz_threshold"]
        counters = super().window(seconds, tracer, sample)
        counters["k2_launches"] = self.ff.launches["madnz_threshold"] - k2
        return counters

    def flags_on_device(self, flags) -> torch.Tensor:
        return flags.transpose(0, 1)

    def checks(self, counters: dict) -> dict:
        """``k2_launch_gap``: one K2 launch a slab, on the card."""
        if self.cell.device.type != "cuda":  # on the CPU K2's plain version runs, and launches nothing
            return {}
        expected = counters["dumps"] * self.slabs
        return {"k2_launch_gap": {"value": abs(counters["k2_launches"] - expected), "limit": 0}}
