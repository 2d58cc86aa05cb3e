"""The plain reference of the 1-D flagger with per-sample input flags: what ingest's flags must be.

katsdpingest flags each correlator dump with the background median left
blind to the samples the dump's own flags mark (katsdpsigproc's FULL
mode): the static mask, CAM's flags of antennas out of service and data
lost in transit.  This is :mod:`flagbench.reference` with that one change
to the background, and it takes everything else from there (the
amplitude, the MAD noise, SumThreshold, the row blocks).  Plain PyTorch;
it imports nothing of the program and takes nothing the program made.

For a row of amplitudes and its flags: a flagged sample is absent
(NaN), the background is the median of the present members of the window
of ``width`` channels centred on each channel (two middle values averaged
where their count is even), and the deviation is ``a - median``, 0 where
the sample is flagged.  A row whose every sample is flagged has only zero
deviations, so its noise is 0 and no window exceeds its threshold.
``dtype=torch.bfloat16`` computes every stage in bfloat16: the control.
"""

import torch

from . import reference


def deviations(amp: torch.Tensor, width: int, flagged: torch.Tensor) -> torch.Tensor:
    """``amp`` less the windowed median of its unflagged members; 0 where `flagged`.

    `flagged` is a (rows, channels) bool mask of the samples left out.
    """
    return reference.deviations(torch.where(flagged, torch.nan, amp), width)


def flag_rows(vis_rows: torch.Tensor, flags_rows: torch.Tensor, flagger: dict,
              dtype=torch.float32) -> torch.Tensor:
    """(rows, channels) uint8 flags of (rows, channels, 2) visibilities and their (rows, channels) flags."""
    dev = deviations(reference.amplitude(vis_rows, dtype), flagger["width"], flags_rows != 0)
    hot = reference.sum_threshold(dev, reference.noise(dev), flagger["n_sigma"],
                                  flagger["n_windows"], flagger["falloff"])
    return hot.to(torch.uint8) * flagger["flag_value"]


def flag_dump(vis: torch.Tensor, input_flags: torch.Tensor, flagger: dict,
              dtype=torch.float32) -> torch.Tensor:
    """(rows, channels) uint8 flags of a channel-major (channels, rows, 2) dump.

    `input_flags` is the dump's channel-major (channels, rows) uint8 flags,
    non-zero where a sample is left out of the background.
    """
    channels, rows = vis.shape[0], vis.shape[1]
    out = torch.empty((rows, channels), dtype=torch.uint8, device=vis.device)
    step = reference.block_rows(channels, flagger["width"])
    for r0 in range(0, rows, step):
        block = vis[:, r0:r0 + step].transpose(0, 1).contiguous()
        flags = input_flags[:, r0:r0 + step].transpose(0, 1).contiguous()
        out[r0:r0 + step] = flag_rows(block, flags, flagger, dtype)
    return out
