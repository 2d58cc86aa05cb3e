"""Benchmark/parity harness for RFI flagging on random data.

Port of ``scripts/rfiflagtest.py``: the 1-D flagger over (channels,
baselines), or with ``--time`` the 2-D ``SumThresholdFlagger`` over
(times, channels, baselines); prints the host oracle's and the device's
times and checks that the masks agree ("Mask mismatches: N / M").

Run::

    python -m katsdpsigproc_tpu_torch.scripts.rfiflagtest [--device cpu] [options]

It runs on the card, and exits without one, unless given ``--device
cpu``, where each kernel takes its plain PyTorch version.  The 1-D
engines are ``torch`` (every stage as tensor code, the counterpart of
``xla``), ``hybrid`` (the background as tensor code, then the kernel K2)
and ``cuda`` (``flag_dump`` of the transposed view: the corner turn K5,
then K1; the counterpart of ``pallas``).  The TPU pipelines
``pallas_dma`` and ``pallas_dma_amp`` have no counterpart.  The 1-D
oracle is :mod:`..models.rfi.host`; the 2-D one, which the JAX harness
does not run, is the numpy re-derivation of the reference in the repo's
``tests/rfi/twodflag_oracle.py``, loaded by path (``--skip-host`` skips
it).
"""

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import common

ROOT = Path(__file__).resolve().parents[2]
TWODFLAG_ORACLE = ROOT / "tests" / "rfi" / "twodflag_oracle.py"


def generate_data(times, channels, baselines):
    rs = np.random.RandomState(seed=1)
    shape = (channels, baselines) if times is None else (times, channels, baselines)
    out = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    out += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mismatches(expected: np.ndarray, flags: np.ndarray) -> bool:
    mismatch = int((expected != flags).sum())
    print(f"Mask mismatches: {mismatch} / {flags.size}", file=sys.stderr)
    return mismatch == 0


def benchmark1d(args, data, device: torch.device) -> bool:
    from katsdpsigproc_tpu_torch.models.rfi import device as rfi_device, fused_flagger
    from katsdpsigproc_tpu_torch.models.rfi import host as rfi_host

    if args.width % 2 != 1:
        raise ValueError("Width must be odd")
    if args.engine == "cuda":
        def fn(vis):
            flags_t = fused_flagger.flag_dump(vis.transpose(0, 1), width=args.width,
                                              n_sigma=args.sigmas)
            return flags_t.transpose(0, 1)
    else:
        fn = rfi_device.make_flagger_fn(args.width, args.sigmas, threshold="sum",
                                        engine=args.engine)
    vis = torch.from_numpy(rfi_device.to_planar(data)).to(device)
    start = time.perf_counter()
    flags = fn(vis).cpu().numpy()
    print(f"Device compile+run: {(time.perf_counter() - start) * 1000:.1f} ms", file=sys.stderr)
    start = time.perf_counter()
    fn(vis)
    _sync(device)
    device_ms = (time.perf_counter() - start) * 1000
    print(f"Device steady-state: {device_ms:.3f} ms", file=sys.stderr)

    if not args.skip_host:
        host_flagger = rfi_host.FlaggerHost(
            rfi_host.BackgroundMedianFilterHost(args.width),
            rfi_host.NoiseEstMADHost(),
            rfi_host.ThresholdSumHost(args.sigmas),
        )
        start = time.perf_counter()
        expected = host_flagger(data)
        host_ms = (time.perf_counter() - start) * 1000
        print(f"Host (oracle): {host_ms:.1f} ms", file=sys.stderr)
        return _mismatches(expected, flags)
    return True


def load_twodflag_oracle():
    """The numpy 2-D oracle of the repo's tests, loaded by path (it imports numpy and math)."""
    if not TWODFLAG_ORACLE.is_file():
        raise SystemExit(f"{TWODFLAG_ORACLE} not found: run from a checkout, or pass --skip-host")
    spec = importlib.util.spec_from_file_location("twodflag_oracle", TWODFLAG_ORACLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark2d(args, data, device: torch.device) -> bool:
    from katsdpsigproc_tpu_torch.models.rfi import twodflag

    flagger = twodflag.SumThresholdFlagger(outlier_nsigma=args.sigmas)
    in_flags = np.zeros(data.shape, bool)
    amp = np.abs(data)
    start = time.perf_counter()
    flags = flagger.get_flags(amp, in_flags, device=device)
    print(f"2-D flagger (compile+run): {(time.perf_counter() - start) * 1000:.1f} ms",
          file=sys.stderr)
    start = time.perf_counter()
    flagger.get_flags(amp, in_flags, device=device)
    print(f"2-D flagger (steady): {(time.perf_counter() - start) * 1000:.1f} ms", file=sys.stderr)
    print(f"Flagged fraction: {flags.mean():.4f}", file=sys.stderr)
    if not args.skip_host:
        oracle = load_twodflag_oracle()
        start = time.perf_counter()
        expected = oracle.get_flags(amp, in_flags, outlier_nsigma=args.sigmas)
        print(f"Host (oracle): {(time.perf_counter() - start) * 1000:.1f} ms", file=sys.stderr)
        return _mismatches(expected, flags)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--time", type=int, help="Number of dumps (selects the 2-D flagger)")
    parser.add_argument("--channels", type=int, default=1024)
    parser.add_argument("--baselines", type=int, default=512)
    parser.add_argument("--width", type=int, default=13)
    parser.add_argument("--sigmas", type=float, default=11.0)
    parser.add_argument("--engine", choices=["torch", "hybrid", "cuda"], default="torch",
                        help="1-D flagger engine: torch (JAX's xla), hybrid, or cuda (JAX's "
                             "pallas); the TPU pipelines pallas_dma and pallas_dma_amp have no "
                             "counterpart")
    parser.add_argument("--skip-host", action="store_true")
    common.add_device_option(parser)
    args = parser.parse_args(argv)
    device = common.harness_device(args.device)

    data = generate_data(args.time, args.channels, args.baselines)
    if args.time is None:
        ok = benchmark1d(args, data, device)
    else:
        ok = benchmark2d(args, data, device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
