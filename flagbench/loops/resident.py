"""The resident loop, and the hooks of the 1-D flagger's dumps that the stream shares.

A dump is channel-major planar visibilities, (channels, rows, 2) float32,
made on the device by :mod:`flagbench.data`; its flags are (rows,
channels) uint8, judged against :mod:`flagbench.reference`.  The mix's
``input_flags`` is ``none`` or ``channel`` (a static mask of the channels
in ``channel_ranges_mhz``).
"""

import time
from typing import Optional

import numpy as np
import torch

from .. import data, reference
from . import Loop, Sample, sync

INPUT_FLAGS = ("none", "channel")


def channel_mask(config: dict, ranges_mhz, device) -> Optional[torch.Tensor]:
    """(channels,) uint8, 1 where a channel's centre frequency lies in a range; None if none.

    Channel c of N over the band [lo, hi) is centred at lo + c * (hi - lo) / N.
    """
    if not ranges_mhz:
        return None
    lo, hi = config["band_mhz"]
    freq = lo + np.arange(config["channels"]) * (hi - lo) / config["channels"]
    mask = np.zeros(config["channels"], dtype=bool)
    for a, b in ranges_mhz:
        mask |= (freq >= a) & (freq <= b)
    return torch.from_numpy(mask.astype(np.uint8)).to(device)


class Resident(Loop):
    """A closed loop with one dump in flight on a ring of dumps on the card.

    Each dump is ``flag_dump(vis.transpose(0, 1))`` (K5 turns the
    channel-major view, K1 flags it) and a synchronise; its latency runs on
    the host's clock from the call to the synchronise's return.  The
    program is reached through its module attributes at the time of each
    call, so a test can put a broken flagger in its place.
    """

    @staticmethod
    def prepare(config: dict):
        from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

        launch = fused_flagger.launch_config(config["channels"])  # builds or loads K1's library
        return "K1 library loaded", f"K1 launch at {config['channels']} channels {launch}"

    @staticmethod
    def n_vis(config: dict) -> int:
        return config["channels"] * config["rows"]

    @staticmethod
    def inputs(cell, seed: int) -> None:
        """The flagger's parameters, the channel mask of ``input_flags`` and the ring of dumps."""
        config, traffic = cell.config, cell.traffic
        if traffic["input_flags"] not in INPUT_FLAGS:
            raise ValueError(f"unknown input_flags mode {traffic['input_flags']!r}")
        cell.flagger = dict(config["flagger"])
        cell.channel_flags = None
        if traffic["input_flags"] == "channel":
            cell.channel_flags = channel_mask(config, traffic["channel_ranges_mhz"], cell.device)
        cell.ring = data.make_ring(seed, config["channels"], config["rows"], traffic["data"],
                                   traffic["ring"], cell.device)

    def __init__(self, cell) -> None:
        from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

        if cell.traffic["in_flight"] != 1:
            raise ValueError("the resident loop keeps 1 dump in flight; the mix must say 1")
        self.cell = cell
        self.ff = fused_flagger
        self.ring = cell.ring

    def _call(self, i: int):
        vis = self.ring[i % len(self.ring)]
        return self.ff.flag_dump(vis.transpose(0, 1), channel_flags=self.cell.channel_flags,
                                 **self.cell.flagger)

    def warm(self) -> None:
        # As many outputs alive at once as the window's sample holds, so
        # that the caching allocator already has every block it will use.
        held = [self._call(i) for i in range(self.cell.traffic["sample"] + 2)]
        sync(self.cell.device)
        del held

    def window(self, seconds: float, tracer, sample: Sample) -> dict:
        dev = self.cell.device
        launches0 = self.ff.launches["flagger"]
        latency, dispatch = [], []
        i = 0
        with tracer.window():
            start = time.perf_counter()  # the profiler, when on, has started
            while True:
                t0 = time.perf_counter()
                with tracer.span("flagbench.flag_dump"):
                    flags = self._call(i)
                t1 = time.perf_counter()
                with tracer.span("flagbench.synchronize"):
                    sync(dev)
                t2 = time.perf_counter()
                latency.append(t2 - t0)
                dispatch.append(t1 - t0)
                sample.offer(i, i % len(self.ring), flags)
                del flags
                i += 1
                if t2 - start >= seconds:
                    break
        return {"dumps": i, "window_s": t2 - start, "latency_s": latency,
                "dispatch_s": dispatch, "missing": 0,
                "k1_launches": self.ff.launches["flagger"] - launches0}

    def dump_on_device(self, slot: int) -> torch.Tensor:
        return self.ring[slot]

    def reference_flags(self, slot: int, dtype=torch.float32) -> torch.Tensor:
        return reference.flag_dump(self.dump_on_device(slot), self.cell.flagger,
                                   self.cell.channel_flags, dtype=dtype)

    def flags_on_device(self, flags) -> torch.Tensor:
        return flags

    def checks(self, counters: dict) -> dict:
        """``k1_launch_gap``: one K1 launch a dump, on the card."""
        if self.cell.device.type != "cuda":  # on the CPU the plain versions run, and launch nothing
            return {}
        return {"k1_launch_gap": {"value": abs(counters["k1_launches"] - counters["dumps"]),
                                  "limit": 0}}
