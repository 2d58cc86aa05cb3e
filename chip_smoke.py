#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one GPU and check it.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

It imports only torch, numpy and ``katsdpsigproc_tpu_torch`` (never jax),
builds the kernels from ``katsdpsigproc_tpu_torch/csrc`` and runs:

1. device: requires CUDA; prints the card's name and power limit;
2. build: builds the kernels and prints the build time and nvcc's
   register report;
3. each kernel against its plain PyTorch version on the card, exact on
   the uint8 flags: K1 in every flag mode at several shapes, with
   n_windows 4 and 6, flag_value 1 and 3, a row holding NaN; K2 on the
   same deviations;
4. the numpy host oracle on the 512 x 64 subsample of the seed-1 dump,
   through K1 and through the hybrid engine (plain background, then K2);
5. the main path at full size: the MeerKAT 4-pol dump (32768 channels x
   2016 baselines x 4 pols = 8064 rows, channel-major planar float32)
   through ``flag_dump`` (K1), the plain version and the hybrid engine
   (K2), which must agree flag for flag, then CUDA-event timings.

Any failure raises and exits non-zero before the result lines.  The
second-to-last line is a JSON record of each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHANNELS, BASELINES, POLS = 32768, 2016, 4
SOURCE = "katsdpsigproc_tpu_torch/csrc/fused_flagger.cu"
REPLACES = {
    "flagger": "katsdpsigproc_tpu/models/rfi/pallas_flagger.py:643",
    "madnz_threshold": "katsdpsigproc_tpu/models/rfi/pallas_flagger.py:762",
}


class Check:
    """Kernel-against-plain comparisons, with the largest error per kernel."""

    def __init__(self):
        self.max_abs_err = {"flagger": 0, "madnz_threshold": 0}

    def flags(self, kernel: str, label: str, got, want) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0
        bad = int((got != want).sum())
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        print(f"  {label}: {bad} mismatching flags of {got.numel()} "
              f"({int(want.count_nonzero())} flagged)")
        if bad:
            raise AssertionError(f"{label}: {bad} mismatching flags")


def test_dump(channels: int, rows: int, seed: int):
    """Complex noise with planted spikes and random prior flags (numpy, seeded)."""
    rs = np.random.RandomState(seed)
    shape = (channels, rows)
    vis = rs.standard_normal(shape) + 1j * rs.standard_normal(shape)
    spikes = rs.random_sample(shape) < 1.0 / 16.0
    vis += spikes * (rs.random_sample(shape) * 20.0 + 50.0) * np.exp(
        2j * np.pi * rs.random_sample(shape))
    flags = ((rs.random_sample(shape) < 1.0 / 16.0) * 2).astype(np.uint8)
    return vis.astype(np.complex64), flags


def meerkat_dump(channels: int, rows: int) -> np.ndarray:
    """The benchmark's seed-1 dump (bench.py:361-366), (channels, rows) complex64."""
    rs = np.random.RandomState(seed=1)
    shape = (channels, rows)
    vis_np = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    vis_np += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    return vis_np


def cuda_time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median over `iters` runs of `fn()`, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    if not (ROOT / "katsdpsigproc_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: katsdpsigproc_tpu_torch/ is not beside this script; "
                 "run it from the root of a checkout")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card)
    return card


def phase_build(ff, kernels) -> None:
    t0 = time.perf_counter()
    ff._library(13)
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")
    for info in kernels.build_info.values():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  nvcc: {line.strip()}")


def phase_kernels(ff, device, check: Check) -> None:
    print("kernels against their plain versions on the card:")
    cases = [(128, 16), (300, 8), (99, 8), (257, 8), (384, 8), (32768, 64)]
    for i, (channels, rows) in enumerate(cases):
        vis, flags = test_dump(channels, rows, seed=100 + i)
        vis_t = torch.from_numpy(device.to_planar(vis.T).copy()).cuda()  # (rows, C, 2)
        flags_t = torch.from_numpy(flags.T.copy()).cuda()
        chan = torch.from_numpy(flags[:, 0].copy()).cuda()
        variants = [("none", {}, {}), ("full", {"input_flags": flags_t}, {}),
                    ("channel", {"channel_flags": chan}, {})]
        if channels == 384:
            variants += [("none", {}, {"n_windows": 6, "flag_value": 3}),
                         ("full", {"input_flags": flags_t}, {"n_windows": 6})]
        for mode, fkw, pkw in variants:
            label = f"K1 C={channels} rows={rows} {mode} {pkw or ''}".rstrip()
            got = ff.flag_transposed(vis_t, **fkw, **pkw)
            want = ff.flag_transposed_plain(vis_t, **fkw, **pkw)
            check.flags("flagger", label, got, want)
            # K2 on the deviations of the same rows
            fmode = {"none": device.BackgroundFlags.NONE, "full": device.BackgroundFlags.FULL,
                     "channel": device.BackgroundFlags.CHANNEL}[mode]
            fl = {"none": None, "full": flags_t.T, "channel": chan}[mode]
            dev_t = device.background_median_filter(
                vis_t.transpose(0, 1), fl, 13, False, fmode).transpose(0, 1).contiguous()
            check.flags("madnz_threshold", label.replace("K1", "K2"),
                        ff.madnz_threshold(dev_t, **pkw), ff.madnz_threshold_plain(dev_t, **pkw))
    # NaN in a row: both the kernel and the plain fast path propagate it
    # through the selection network as jnp.minimum/maximum do.
    vis, _ = test_dump(300, 8, seed=200)
    vis[[5, 150, 299], 2] = np.nan
    vis[0, 3] = np.nan + 0j
    vis_t = torch.from_numpy(device.to_planar(vis.T).copy()).cuda()
    check.flags("flagger", "K1 NaN rows", ff.flag_transposed(vis_t),
                ff.flag_transposed_plain(vis_t))
    torch.cuda.synchronize()


def phase_oracle(ff, device, host, vis_np: np.ndarray, check: Check) -> None:
    print("against the numpy host oracle, 512 x 64 subsample:")
    sub = vis_np[:512, :64]
    expected = torch.from_numpy(host.FlaggerHost(
        host.BackgroundMedianFilterHost(13), host.NoiseEstMADHost(),
        host.ThresholdSumHost(11.0))(sub))
    planar = device.to_planar(sub)
    k1 = ff.flag_transposed(torch.from_numpy(np.moveaxis(planar, 0, 1).copy()).cuda(),
                            width=13, n_sigma=11.0)
    check.flags("flagger", "K1 vs host oracle", k1.T.cpu(), expected)
    hybrid = device.make_flagger_fn(13, 11.0, engine="hybrid")(torch.from_numpy(planar).cuda())
    check.flags("madnz_threshold", "hybrid (K2) vs host oracle", hybrid.cpu(), expected)


def phase_main(ff, device, vis_np: np.ndarray, card: str, check: Check) -> dict:
    rows = vis_np.shape[1]
    n_vis = vis_np.size
    print(f"main path: {vis_np.shape[0]} channels x {rows} rows")
    vis = torch.from_numpy(device.to_planar(vis_np)).cuda()  # (C, rows, 2), channel-major
    block = 1008
    hybrid_fn = device.make_flagger_fn(13, 11.0, engine="hybrid", baseline_block=block)

    for name in ff.launches:
        ff.launches[name] = 0
    k1 = ff.flag_dump(vis.transpose(0, 1).contiguous())  # (rows, C)
    hybrid = hybrid_fn(vis)  # (C, rows)
    torch.cuda.synchronize()
    launches = dict(ff.launches)
    print(f"  launches during the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    vis_t = vis.transpose(0, 1).contiguous()

    def plain_k1():
        out = torch.empty((rows, vis.shape[0]), dtype=torch.uint8, device=vis.device)
        for s in range(0, rows, 2 * block):
            out[s:s + 2 * block] = ff.flag_transposed_plain(vis_t[s:s + 2 * block])
        return out

    plain = plain_k1()
    if not (k1.shape == plain.shape and set(k1.unique().tolist()) <= {0, 1}):
        raise AssertionError(f"unexpected K1 output {k1.shape} {k1.unique().tolist()}")
    check.flags("flagger", "full dump: K1 (flag_dump) vs plain", k1, plain)
    check.flags("madnz_threshold", "full dump: hybrid (K2) vs K1", hybrid.T, k1)
    print(f"  flagged fraction {float(k1.float().mean()):.5f}")

    # K2 against its plain version on the full dump's deviations.
    dev_t = torch.empty((rows, vis.shape[0]), dtype=torch.float32, device=vis.device)
    for s in range(0, rows, block):
        dev_t[s:s + block] = device.background_median_filter(
            vis[:, s:s + block], None, 13, False, device.BackgroundFlags.NONE,
            fast_path=False).T
    k2 = ff.madnz_threshold(dev_t)

    def plain_k2():
        out = torch.empty((rows, vis.shape[0]), dtype=torch.uint8, device=vis.device)
        for s in range(0, rows, 2 * block):
            out[s:s + 2 * block] = ff.madnz_threshold_plain(dev_t[s:s + 2 * block])
        return out

    check.flags("madnz_threshold", "full dump: K2 vs plain", k2, plain_k2())
    check.flags("madnz_threshold", "full dump: K2 vs K1", k2, k1)
    del plain, hybrid, k1, k2

    print(f"timings (CUDA events, 2 warm-ups, median of 10) on {card}:")
    times = {
        "K1 flag_dump, corner turn excluded": cuda_time_ms(lambda: ff.flag_dump(vis_t)),
        "K1 flag_dump, corner turn included": cuda_time_ms(
            lambda: ff.flag_dump(vis.transpose(0, 1).contiguous())),
        "K1 plain (flag_transposed_plain)": cuda_time_ms(plain_k1),
        "hybrid engine (plain background + K2)": cuda_time_ms(lambda: hybrid_fn(vis)),
        "K2 madnz_threshold": cuda_time_ms(lambda: ff.madnz_threshold(dev_t)),
        "K2 plain (madnz_threshold_plain)": cuda_time_ms(plain_k2),
    }
    for name, ms in times.items():
        print(f"  {name}: {ms:.3f} ms, {n_vis / ms / 1e6:.3f} Gvis/s [{card}]")
    return {
        "flagger": (launches["flagger"], times["K1 flag_dump, corner turn excluded"],
                    times["K1 plain (flag_transposed_plain)"]),
        "madnz_threshold": (launches["madnz_threshold"], times["K2 madnz_threshold"],
                            times["K2 plain (madnz_threshold_plain)"]),
    }


def main() -> None:
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    from katsdpsigproc_tpu_torch.models.rfi import device, fused_flagger as ff, host
    from katsdpsigproc_tpu_torch.utils import kernels

    check = Check()
    phase_build(ff, kernels)
    phase_kernels(ff, device, check)
    t0 = time.perf_counter()
    vis_np = meerkat_dump(CHANNELS, BASELINES * POLS)
    print(f"dump generated on the host in {time.perf_counter() - t0:.1f} s")
    phase_oracle(ff, device, host, vis_np, check)
    results = phase_main(ff, device, vis_np, card, check)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches, "max_abs_err": check.max_abs_err[name], "ms": ms,
         "plain_ms": plain_ms}
        for name, (launches, ms, plain_ms) in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
