"""The 2-D loop's calibrator scans and input flags, made on the device from the run's seed.

A scan is (dumps, channels, products) complex64 visibilities of a
calibrator: complex Gaussian noise of unit sigma in each part on the
calibrator's visibility, a per-product complex gain of amplitude
``gain_low`` to ``gain_high`` times a smooth ripple across the band, and
interference as the traffic file's ``data`` entry sets it, each raising
the amplitude in phase with the product's gain:

* bursts (DME-like): in a share of the dumps (``burst_dump_fraction``),
  ``burst_channels`` channels around each centre from
  ``burst_range_mhz[0]`` up to ``burst_range_mhz[1]`` in steps of
  ``burst_spacing_mhz``, of uniform amplitude from ``burst_low`` to
  ``burst_high`` per (dump, centre, product);
* rises: in a share of (dump, product) pairs (``rise_fraction``), a
  broadband rise of ``rise_low`` to ``rise_high`` across every channel;
* spikes: a share of the samples (``spike_fraction``), of ``spike_low`` to
  ``spike_high``.

The input flags, (dumps, channels, products) uint8, are 1 in every channel
whose centre lies in one of ``channel_ranges_mhz`` (a static mask) and in a
share of the samples (``sample_fraction``): what ingest hands to the
calibration pipeline.

Channel c of the configuration lies at ``band_mhz[0] + (first_channel + c)
* width``, ``width`` the band over ``band_channels``.  Everything is drawn
by one ``torch.Generator`` on the device, in the same order for every seed.
"""

import math

import numpy as np
import torch

from .data import generator


def channel_mhz(config: dict) -> np.ndarray:
    """The centre frequency of each of the configuration's channels, in MHz."""
    lo, hi = config["band_mhz"]
    width = (hi - lo) / config["band_channels"]
    return lo + (config["first_channel"] + np.arange(config["channels"])) * width


def _uniform(gen, shape, low: float, high: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device).mul_(high - low).add_(low)


def make_scan(gen: torch.Generator, config: dict, data: dict, device) -> torch.Tensor:
    """One (dumps, channels, products) complex64 scan from `gen`, with `data`'s interference."""
    n_time, n_freq, n_prod = config["dumps"], config["channels"], config["products"]
    pairs = torch.randn((n_time, n_freq, n_prod, 2), generator=gen, device=device)
    vis = torch.view_as_complex(pairs)
    gain_amp = _uniform(gen, (n_prod,), data["gain_low"], data["gain_high"], device)
    phase = _uniform(gen, (n_prod,), 0.0, 2 * math.pi, device)
    unit = torch.polar(torch.ones_like(phase), phase)  # the gain's direction
    ripple_phase = _uniform(gen, (n_prod,), 0.0, 2 * math.pi, device)
    chan = torch.arange(n_freq, device=device, dtype=torch.float32)[:, None]
    ripple = 1.0 + data["ripple"] * torch.sin(
        2 * math.pi * data["ripple_periods"] * chan / n_freq + ripple_phase)
    vis += (gain_amp * ripple) * unit  # (channels, products), the same in every dump

    n_burst = int(round(n_time * data["burst_dump_fraction"]))
    burst_dumps = torch.rand(n_time, generator=gen, device=device).argsort()[:n_burst]
    freq = channel_mhz(config)
    width = freq[1] - freq[0] if n_freq > 1 else 1.0
    lo_mhz, hi_mhz = data["burst_range_mhz"]
    centres = np.arange(lo_mhz, hi_mhz, data["burst_spacing_mhz"])
    centre_chan = np.round((centres - freq[0]) / width).astype(np.int64)
    burst_amp = _uniform(gen, (n_burst, len(centres), n_prod), data["burst_low"],
                         data["burst_high"], device)
    bursts = torch.zeros((n_burst, n_freq, n_prod), device=device)
    half = data["burst_channels"] // 2
    for k in range(-half, data["burst_channels"] - half):
        inside = (centre_chan + k >= 0) & (centre_chan + k < n_freq)
        idx = torch.from_numpy(centre_chan[inside] + k).to(device)
        bursts[:, idx] += burst_amp[:, torch.from_numpy(np.flatnonzero(inside)).to(device)]
    for i, t in enumerate(burst_dumps.tolist()):
        vis[t] += bursts[i] * unit

    rises = torch.rand((n_time, n_prod), generator=gen, device=device) < data["rise_fraction"]
    rise_amp = _uniform(gen, (n_time, n_prod), data["rise_low"], data["rise_high"], device)
    vis += (torch.where(rises, rise_amp, 0.0) * unit)[:, None, :]

    for t in range(n_time):  # a dump at a time, so that no draw is the size of the scan
        spikes = torch.rand((n_freq, n_prod), generator=gen, device=device) < data["spike_fraction"]
        spike_amp = _uniform(gen, (n_freq, n_prod), data["spike_low"], data["spike_high"], device)
        vis[t] += torch.where(spikes, spike_amp, 0.0) * unit
    return vis


def make_flags(gen: torch.Generator, config: dict, input_flags: dict, device) -> torch.Tensor:
    """(dumps, channels, products) uint8 input flags: the static channel mask and sampled flags."""
    shape = (config["dumps"], config["channels"], config["products"])
    freq = channel_mhz(config)
    mask = np.zeros(config["channels"], dtype=bool)
    for a, b in input_flags["channel_ranges_mhz"]:
        mask |= (freq >= a) & (freq <= b)
    static = torch.from_numpy(mask).to(device)[:, None]
    flags = torch.empty(shape, dtype=torch.uint8, device=device)
    for t in range(shape[0]):
        sampled = torch.rand(shape[1:], generator=gen, device=device)
        flags[t] = (sampled < input_flags["sample_fraction"]) | static
    return flags


def make_ring(seed: int, config: dict, traffic: dict, device) -> list:
    """``traffic["ring"]`` distinct (scan, input flags) pairs, the ring the 2-D loop cycles through."""
    gen = generator(seed, device)
    ring = []
    for _ in range(traffic["ring"]):
        scan = make_scan(gen, config, traffic["data"], device)
        ring.append((scan, make_flags(gen, config, traffic["input_flags"], device)))
    return ring
