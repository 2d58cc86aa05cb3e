"""The 2-D loop: katsdpcal's flagging of calibrator scans held on the card.

A scan is (dumps, channels, products) complex64 visibilities with uint8
input flags, made on the device by :mod:`flagbench.data_twod`; its flags
are (dumps, channels, products) bool, judged against
:mod:`flagbench.reference_twod`.  The mix gives the ring, the sample, the
data's interference (``data``) and the input flags (``input_flags``).
"""

import time

import torch

from .. import data_twod, reference_twod
from . import Loop, Sample, sync


class TwoD(Loop):
    """A closed loop with one scan in flight on a ring of scans on the card.

    Each call is ``SumThresholdFlagger(**flagger).get_flags(scan,
    input_flags)`` on the scan's device with the program's default
    batches, and a synchronise;
    its latency runs on the host's clock from the call to the
    synchronise's return.  Whatever the call returns (a tensor on the
    card, or a host array from a program that returns one) is taken to the
    card for the check.
    """

    @staticmethod
    def prepare(config: dict):
        """Refuse, at once, a program that cannot keep a scan's flags on the card.

        The cell measures a scan resident on the card.  A program whose
        ``get_flags`` hands the flags of a scan on the card back to the
        host (a numpy array, synchronised batch by batch) cannot run it:
        the run raises here, before any scan is made, rather than time
        that round trip.
        """
        from katsdpsigproc_tpu_torch.models.rfi import twodflag

        probe = torch.ones((4, 16, 2), dtype=torch.complex64, device="cuda")
        flags = torch.zeros(probe.shape, dtype=torch.uint8, device=probe.device)
        out = twodflag.SumThresholdFlagger(**config["flagger"]).get_flags(probe, flags,
                                                                         device=probe.device)
        if not (isinstance(out, torch.Tensor) and out.device == probe.device):
            raise RuntimeError(f"get_flags gave {type(out).__name__} for a scan on the card: "
                               "this cell needs the flags of a scan on the card left there")
        return "get_flags probed", "get_flags keeps a scan's flags on the card"

    @staticmethod
    def n_vis(config: dict) -> int:
        return config["dumps"] * config["channels"] * config["products"]

    @staticmethod
    def inputs(cell, seed: int) -> None:
        """The flagger's parameters and the ring of (scan, input flags) pairs."""
        cell.flagger = dict(cell.config["flagger"])
        cell.ring = data_twod.make_ring(seed, cell.config, cell.traffic, cell.device)

    def __init__(self, cell) -> None:
        from katsdpsigproc_tpu_torch.models.rfi import twodflag

        if cell.traffic["in_flight"] != 1:
            raise ValueError("the 2-D loop keeps 1 scan in flight; the mix must say 1")
        self.cell = cell
        self.twodflag = twodflag
        self.ring = cell.ring

    def _call(self, i: int):
        scan, flags = self.ring[i % len(self.ring)]
        flagger = self.twodflag.SumThresholdFlagger(**self.cell.flagger)
        return flagger.get_flags(scan, flags, device=scan.device)

    def warm(self) -> None:
        # Eager PyTorch builds nothing for a shape: one scan loads every
        # kernel the window runs.
        self._call(0)
        sync(self.cell.device)

    def window(self, seconds: float, tracer, sample: Sample) -> dict:
        """Scans back to back; ``twod_batches`` is the program's batch counter over the window."""
        batches = getattr(self.twodflag, "batches", None)
        before = dict(batches) if batches else None
        latency = []
        i = 0
        with tracer.window():
            start = time.perf_counter()  # the profiler, when on, has started
            while True:
                t0 = time.perf_counter()
                with tracer.span("flagbench.get_flags"):
                    flags = self._call(i)
                with tracer.span("flagbench.synchronize"):
                    sync(self.cell.device)
                t1 = time.perf_counter()
                latency.append(t1 - t0)
                sample.offer(i, i % len(self.ring), flags)
                del flags
                i += 1
                if t1 - start >= seconds:
                    break
        counters = {"dumps": i, "window_s": t1 - start, "latency_s": latency, "missing": 0}
        if before is not None:
            counters["twod_batches"] = {k: batches[k] - before[k] for k in before}
        return counters

    def reference_flags(self, slot: int, dtype=torch.float32) -> torch.Tensor:
        scan, flags = self.ring[slot]
        return reference_twod.flag_scan(scan, flags, self.cell.flagger, dtype=dtype)

    def flags_on_device(self, flags) -> torch.Tensor:
        return torch.as_tensor(flags).to(self.cell.device)
