"""The ingest loop: the resident loop on dumps that carry per-sample input flags (FULL mode).

Each ring slot is a (dump, flags) pair made on the card from the seed: a
channel-major (channels, rows, 2) float32 dump of :mod:`flagbench.data`
and its channel-major (channels, rows) uint8 flags, each population of
the mix an OR of its bit (the configuration's ``input_flag_bits``):

* ``static``: every row of the channels in ``channel_ranges_mhz``, where
  transmitter power of ``power_low`` to ``power_high`` is added to the
  real part, so that a mask left out changes the flags;
* ``cam``: every row of ``antennas_flagged`` antennas' baselines, an
  antenna of its own for each slot;
* ``data_lost``: ``blocks`` blocks of ``block_channels`` adjacent channels
  on their stream's boundaries, in every row, the visibilities under them
  zeroed.

Rows are baselines of the upper triangle (i < j) in order, each with its
``pols`` products, so row = baseline x pols + pol.  A dump is
``flag_dump(vis.transpose(0, 1), flags.transpose(0, 1))``: K5 turns both
and K1 runs in its FULL mode, judged against
:mod:`flagbench.reference_ingest`.
"""

import numpy as np
import torch

from .. import data, reference_ingest
from .resident import Resident, channel_mask


def antenna_rows(config: dict, antenna: int) -> np.ndarray:
    """The rows of every baseline of `antenna`, each with its polarisation products."""
    i, j = np.triu_indices(config["antennas"], k=1)
    if len(i) != config["baselines"] or config["baselines"] * config["pols"] != config["rows"]:
        raise ValueError("rows must be the upper triangle's baselines times the pols")
    baselines = np.flatnonzero((i == antenna) | (j == antenna))
    return (baselines[:, None] * config["pols"] + np.arange(config["pols"])).ravel()


def make_ring(seed: int, config: dict, traffic: dict, device):
    """The ring's dumps and their flags: two lists of `traffic["ring"]` tensors."""
    channels, rows = config["channels"], config["rows"]
    bits = config["input_flag_bits"]
    static, cam, lost = traffic["static"], traffic["cam"], traffic["data_lost"]
    gen = data.generator(seed, device)
    size = traffic["ring"]
    ring = [data.make_dump(gen, channels, rows, traffic["data"], device) for _ in range(size)]
    mask = channel_mask(config, static["channel_ranges_mhz"], device).bool()
    streams = channels // lost["block_channels"]
    antennas = torch.randperm(config["antennas"], generator=gen, device=device)
    antennas = antennas[:size * cam["antennas_flagged"]].tolist()
    flags_ring = []
    for slot, vis in enumerate(ring):
        flags = torch.zeros((channels, rows), dtype=torch.uint8, device=device)
        flags[mask] |= bits["static"]
        power = torch.rand((int(mask.sum()), rows), generator=gen, device=device)
        vis[mask, :, 0] += power.mul_(static["power_high"] - static["power_low"]).add_(
            static["power_low"])
        mine = antennas[slot * cam["antennas_flagged"]:(slot + 1) * cam["antennas_flagged"]]
        for antenna in mine:
            flags[:, torch.from_numpy(antenna_rows(config, antenna)).to(device)] |= bits["cam"]
        for stream in torch.randperm(streams, generator=gen, device=device)[:lost["blocks"]]:
            block = slice(int(stream) * lost["block_channels"],
                          (int(stream) + 1) * lost["block_channels"])
            flags[block] |= bits["data_lost"]
            vis[block] = 0.0
        flags_ring.append(flags)
    return ring, flags_ring


class FullFlags(Resident):
    """The resident loop, each dump flagged with its own per-sample flags.

    Its checks add ``k1_full_gap`` to the resident loop's: one launch of
    K1's FULL mode a dump, from the program's counter
    ``fused_flagger.k1_modes``; a program without that counter is refused
    before any input is made.
    """

    @staticmethod
    def prepare(config: dict):
        from katsdpsigproc_tpu_torch.models.rfi import fused_flagger

        if not hasattr(fused_flagger, "k1_modes"):
            raise RuntimeError("the program has no counter fused_flagger.k1_modes, which this "
                               "loop's check k1_full_gap reads")
        return Resident.prepare(config)

    @staticmethod
    def inputs(cell, seed: int) -> None:
        """The flagger's parameters and the ring of (dump, flags) pairs."""
        if cell.traffic["input_flags"] != "full":
            raise ValueError("the fullflags loop takes input_flags 'full'")
        cell.flagger = dict(cell.config["flagger"])
        cell.channel_flags = None
        cell.ring, cell.input_flags = make_ring(seed, cell.config, cell.traffic, cell.device)

    def _call(self, i: int):
        slot = i % len(self.ring)
        return self.ff.flag_dump(self.ring[slot].transpose(0, 1),
                                 self.cell.input_flags[slot].transpose(0, 1), **self.cell.flagger)

    def window(self, seconds: float, tracer, sample) -> dict:
        full0 = self.ff.k1_modes["full"]
        counters = super().window(seconds, tracer, sample)
        counters["k1_full_launches"] = self.ff.k1_modes["full"] - full0
        return counters

    def reference_flags(self, slot: int, dtype=torch.float32) -> torch.Tensor:
        return reference_ingest.flag_dump(self.ring[slot], self.cell.input_flags[slot],
                                          self.cell.flagger, dtype=dtype)

    def checks(self, counters: dict) -> dict:
        """The resident loop's, and ``k1_full_gap``: one FULL-mode K1 launch a dump, on the card."""
        out = super().checks(counters)
        if self.cell.device.type == "cuda":
            out["k1_full_gap"] = {"value": abs(counters["k1_full_launches"] - counters["dumps"]),
                                  "limit": 0}
        return out
