"""The cells' dumps, made on the device from the run's seed.

A dump is channel-major planar visibilities, (channels, rows, 2) float32
(re, im) pairs: complex Gaussian noise of unit variance in each part, and
two populations of interference added to the real part, as the traffic
file's ``data`` entry sets them:

* spikes: a share (``spike_fraction``) of the samples, of uniform amplitude
  from ``spike_low`` to ``spike_high``.  With 1/64 and 50 to 70 that is the
  TPU package's benchmark dump (``bench.py``, ``scripts/common.meerkat_dump``);
* runs: in a share of (channel, row) places (``run_fraction``) a run of
  ``run_channels`` adjacent channels starts, each sample of uniform
  amplitude from ``run_low`` to ``run_high``: narrowband interference near
  the detection threshold, where the SumThreshold windows decide the flags.

Everything is drawn by one ``torch.Generator`` on the device, in a few
large calls, in the same order for every seed.
"""

import torch

# torch.Generator takes seeds in [0, 2**64); a run's seed is any whole number.
_SEED_MODULUS = 1 << 64


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from `seed` (any whole number)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % _SEED_MODULUS)
    return gen


def _uniform(gen, shape, low: float, high: float, device) -> torch.Tensor:
    values = torch.rand(shape, generator=gen, device=device)
    return values.mul_(high - low).add_(low)


def make_dump(gen: torch.Generator, channels: int, rows: int, data: dict,
              device) -> torch.Tensor:
    """One (channels, rows, 2) float32 dump from `gen`, with `data`'s interference."""
    shape = (channels, rows)
    vis = torch.randn(shape + (2,), generator=gen, device=device, dtype=torch.float32)
    spikes = torch.rand(shape, generator=gen, device=device) < data["spike_fraction"]
    amp = _uniform(gen, shape, data["spike_low"], data["spike_high"], device)
    vis[..., 0].add_(torch.where(spikes, amp, 0.0))
    starts = torch.rand(shape, generator=gen, device=device) < data["run_fraction"]
    run = starts.clone()
    for k in range(1, min(data["run_channels"], channels)):
        run[k:] |= starts[:-k]
    amp = _uniform(gen, shape, data["run_low"], data["run_high"], device)
    vis[..., 0].add_(torch.where(run, amp, 0.0))
    return vis


def make_ring(seed: int, channels: int, rows: int, data: dict, size: int, device) -> list:
    """`size` distinct dumps, the ring a cell's loop cycles through."""
    gen = generator(seed, device)
    return [make_dump(gen, channels, rows, data, device) for _ in range(size)]
