"""What the probe scripts and harnesses share: the card, the dump and the CLI."""

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

# The main path's dump: 32768 channels x 2016 baselines x 4 pols.
CHANNELS, ROWS = 32768, 2016 * 4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock, its maximum, power draw and temperature now, as nvidia-smi reads them."""
    state = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    return f"{state} (SM clock, max SM clock, power draw, temperature)"


def require_card() -> str:
    """Exit unless a CUDA device is present; returns :func:`card_line`."""
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe measures the card and runs only there")
    return card_line()


def add_device_option(parser: argparse.ArgumentParser) -> None:
    """The harnesses' ``--device``: the card by default, or the CPU with the plain versions."""
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to run (default %(default)s; cpu runs the plain versions)")


def harness_device(name: str) -> torch.device:
    """The device a harness runs on; exits when it asks for the card and there is none."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def clock_name(device: torch.device) -> str:
    """How ``utils/profiling.time_fn`` times a call on `device`."""
    return "CUDA events" if device.type == "cuda" else "host clock"


def device_line(device: torch.device) -> str:
    """The card's name and power limit (:func:`card_line`), or ``cpu``."""
    return card_line() if device.type == "cuda" else "cpu"


def meerkat_dump(channels: int, rows: int) -> np.ndarray:
    """The benchmark's seed-1 dump (bench.py:361-366), (channels, rows) complex64."""
    rs = np.random.RandomState(seed=1)
    shape = (channels, rows)
    vis_np = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    vis_np += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    return vis_np


def dump_on_card(channels: int, rows: int) -> torch.Tensor:
    """:func:`meerkat_dump` as channel-major planar (channels, rows, 2) float32 on the card."""
    vis_np = meerkat_dump(channels, rows)
    planar = np.stack([vis_np.real, vis_np.imag], axis=-1)
    return torch.from_numpy(planar).cuda()


def parser(doc: str) -> argparse.ArgumentParser:
    """The probes' common options: the dump's size and the timing loop."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--baselines", type=int, default=ROWS,
                    help="rows of the dump, baselines x pols (default %(default)s)")
    ap.add_argument("--iters", type=int, default=3,
                    help="back-to-back calls per timed sample (default %(default)s)")
    ap.add_argument("--reps", type=int, default=5,
                    help="rounds of interleaved samples (default %(default)s)")
    return ap


def host_us(fns: dict, calls_each: int = 200) -> dict:
    """Host microseconds per call of each callable, over `calls_each` calls queued back to back."""
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls_each):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls_each * 1e6
    return out


def verdict(gap: float, *spreads: float) -> str:
    """Whether a gap between two medians exceeds every spread (max - min) given."""
    return "beyond both" if abs(gap) > max(spreads) else "within"


def report(name: str, median: float, samples, card: str) -> None:
    """One variant's median, min and samples in ms, with the card."""
    print(f"{name:12s} med {median:8.3f} ms  min {min(samples):8.3f} ms  "
          f"all={[round(t, 3) for t in samples]} [{card}]")
