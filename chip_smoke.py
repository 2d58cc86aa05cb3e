#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one GPU and check it.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

It imports only torch, numpy, ``katsdpsigproc_tpu_torch`` and, in phase
13, the benchmark's ``flagbench`` (never jax), builds the kernels from
``katsdpsigproc_tpu_torch/csrc`` and runs:

1. device: requires CUDA; prints the card's name and power limit;
2. build: builds the kernel libraries with one ``nvcc`` each, all
   started together, and prints the build time and nvcc's register
   report; K1's ``flagger_kernel`` and its wide-row path
   (``flagger_wide_kernel``, with K2's ``madnz_threshold_wide_kernel``) at
   width 13 and at each of :data:`WIDE_WIDTHS`, K2's
   ``madnz_threshold_kernel``, every instance of K4's
   ``percentile5_radix_kernel``, every K9, K11, K13 and ``channel_major``
   instance of ``flagger_probe.cu``'s ``probe_kernel``, each instance of
   K12 (clusters of 1, 2, 4 and 8 rows, baseline-major),
   K10's ``skeleton_kernel``, every instance of K8 at K1's launch
   (``k1_prim_kernel``) and the 2-D flagger's ``masked_median_kernel``
   (``median_lines_kernel`` and both ``median_block_kernel``s, with no
   SASS local load or store either) must spill no bytes, and the SASS local loads and
   stores of each are counted (``cuobjdump -sass``), with the SASS
   instructions a rep of each K8 body costs an element;
3. each kernel against its plain PyTorch version on the card, exact on
   the uint8 flags: K1 in every flag mode at the edge shapes of its run
   layout (1, 13, 99, 257, 1023, 1024, 1025, 4097 and 32768 channels and
   its channel limit), each with n_windows 4 and 6, flag_value 1 and 3,
   rows holding NaN; K2, which now has K1's layout, on the same
   deviations at every one of those shapes, and on deviations K1 never
   makes (NaN, +-inf, -0, denormals, all-zero rows) at the same shapes; K1 in
   every flag mode and K2 on the wide-row path at the limit + 1, 65536,
   65537 and 131072 channels; K1 at the widths :data:`WIDE_WIDTHS`, on
   both sides of the switch from a network over registers to counted
   ranks and on the wide-row path; then K1 and K2 on the wide-row path
   over the seed-1 dump of 65536 channels x 2016 rows, against their
   plain versions and each other, timed;
4. the numpy host oracle on the 512 x 64 subsample of the seed-1 dump,
   through K1 and through the hybrid engine (the background kernel, then
   K2);
5. the main path at full size: the MeerKAT 4-pol dump (32768 channels x
   2016 baselines x 4 pols = 8064 rows, channel-major planar float32)
   through ``flag_dump(vis.transpose(0, 1))``, the bench's call (K5's
   corner turn, then K1), the plain version, ``flag_transposed_dma`` on
   the view and on a
   (2, rows, channels) copy (``layout="leading"``), and the hybrid engine
   (the background kernel and K2 a slab) on its general and its fast
   background (``background_fast=True``), which must agree flag for flag,
   with one K1 launch per call; then CUDA-event timings, both hybrid paths
   among them;
6. the ops path: K4 (percentile5) and K5 (transpose) against their plain
   versions, exact, at every size below, K4 also on rows of NaN, +-inf,
   -0, negatives, denormals and equal values, at rows below and above the
   SM count, at the edges of its register, shared-memory and
   device-memory paths and on column-range views; the plain ops (Fill, MaskedSum,
   HReduce) against numpy float64 at bench configs 2 and 3; a forced
   tuner search for each autotuned template; both Operation call styles;
   then configs 2 and 3 and the 4000 x 5000 percentile run through the
   templates with the launch counts read, and CUDA-event timings, K4's
   beside ``torch.quantile`` at 4000 x 5000 and 64 x 4096, and K4's bound
   at both shapes;
7. ``FlaggerDevice`` (median background, transposed MAD noise,
   SumThreshold as an ``OperationSequence``) over the whole dump as
   complex64, whose flags must equal K1's on the same rows;
8. K1's stage probes (``csrc/flagger_probe.cu``): each variant's launch
   configuration as the libraries report it, K9's, K11's and K13's equal
   to K1's (the run layout: 1024 threads, K1's shared memory, one CTA per
   SM), and K12's too, with the clusters of each of its instances that fit
   the card; every variant against its plain version, exact, at
   several shapes and on 512 rows of the dump; on the whole dump,
   ``full``, ``rank_pair``, ``zeros_fold``, ``radix_select``,
   ``shfl_median``, ``window_median``, ``channel_major`` (reading the
   channel-major dump in place) against K1, every ``stage_ablate`` variant
   against its plain version, and ``amp_pairs`` in both layouts and at
   every cluster against the plain amplitude; then the profiling path,
   the four probe tools' ``run`` on the whole dump with the launch counts
   read, which prints the stage costs, each K9 variant less ``full``
   against both spreads and, from ``deinterleave_probe``, K12 at each
   cluster, K5, K1, K5 + K1 and
   ``channel_major`` interleaved, with ``channel_major`` less K5 + K1
   against both spreads; and the plain versions' times;
9. the examples and the cost probes: the tutorial kernels K6 (Triton) and
   K7 (``csrc/examples.cu``) against ``x * 3`` and ``data * scale``,
   exact, at the examples' sizes, at their tiles' edges and at 2**28
   float32; the examples' entry point (every example's ``main`` on the
   card) with the launch counts read; K7 and K6 against their plain
   versions and PyTorch's calls, 5 interleaved rounds at 2**28,
   host-paced; K8 (``csrc/prim_cost.cu``) at K1's launch against its
   plain chains on (132, 32768), (137, 32768) and (7, 4160), and K10
   (``csrc/roofline_skeleton.cu``) against its plain version on its uint8
   output and its rank carry, at several shapes and on 512 rows and the
   whole of the dump; the cost-probe path (K8's per-op table, then K10
   and K11's ``full``, ``no_median``, ``no_rank``, ``no_thresh`` and
   ``skeleton`` on the whole dump in the same rounds, beside the model of
   ``models/rfi/roofline.py`` priced by the shipped table and by K8, stage
   by stage against K11's stage costs) with the launch counts read; K8's
   add chain on (264, 32768), two full waves of one CTA per SM,
   device-paced (the record), which gives the float32 instruction rate
   beside :data:`F32_OPS_PER_S`; then the
   streaming ingest example at the full dump (5 dumps through one device
   slot and K1), each dump's flags equal to ``flag_dump``'s on the card,
   with the upload, flag and pipeline times.  K10 and K8 are held to K1's
   launch (the run layout);
10. the 2-D and FFT paths and ``FusedFlaggerTemplate``: the 2-D path is
   plain PyTorch as XLA computes it in JAX, but for its masked Gaussian
   filter, which on the card is the box-filter kernels
   (``csrc/box_filter.cu``), SumThreshold's window chain, the kernel
   of ``csrc/sum_threshold.cu``, and its masked medians, the kernel of
   ``csrc/masked_median.cu``.  First those, ``masked_gaussian_filter`` on
   card tensors at a calibrator scan's batch shapes, 2016 baselines x 75
   dumps x 1024 channels, baselines innermost as the flagger's averaged
   data lies (sigma (0, 12.5, 10): ``box_strided_kernel`` twice), and its
   spectrum, (2016, 1, 1024) contiguous (sigma (0, 0, 10):
   ``box_rows_kernel``), each with unflagged NaN and inf and 80 channels all
   flagged, bit for bit the plain version (``masked_gaussian_filter_plain``)
   on the same tensors, then both timed; the SumThreshold kernel's spill
   report (none allowed), then ``sum_threshold_cuda`` at the same batch,
   baselines innermost, on the time lines (one chunk) and the frequency
   lines (8 chunks), windows 1, 2, 4, 8, unflagged NaN and inf, flag for
   flag its plain version (``sum_threshold_plain``) on the same tensors
   and noise estimates, and its spectrum, (2016, 1, 1024) contiguous, in
   8 chunks, one launch a call; then the three calls timed together
   against 5 B a sample a call at :data:`HBM_BYTES_PER_S` and
   :func:`sum_threshold_ops` at :data:`F32_OPS_PER_S`; the median kernel's
   six calls of the same batch (the time median, the spectrum's background
   and thresholds, the 2-D background's blocks of 75 x 128, the time and
   the frequency thresholds, 8 chunks in frequency, in the flagger's
   layouts), bit for bit its plain version (``masked_median_plain``, a
   sort a chunk), one launch a call, then each call timed and the six
   together against 5 B a sample and the 34 sorts.  Then the 2-D
   ``SumThresholdFlagger`` at ``bench.py`` config 1 (3000 times x 1024
   channels x 1 baseline, seed 1) and on ``rfiflagtest``'s spiked data
   (3000 x 1024 x 16, one chunk of ``get_flags``), each equal flag for
   flag to the port's run on the CPU and, on one baseline, to the numpy
   oracle ``tests/rfi/twodflag_oracle.py``, with ``twodflag.box_filters``,
   ``twodflag.sum_thresholds``, ``twodflag.medians`` and
   ``twodflag.launches`` set to 0 just before the card's run and read just
   after (every filter on the kernels, the launches its plan gives; 3
   SumThreshold chains a batch, each one launch of its kernel; 6 medians a
   batch, each one launch of its kernel),
   timed; ``fftflagtest``'s pipeline at config 4 (256 x 32768 float32):
   the ``Fft`` r2c and c2r operations against the CPU run, each row's
   relative error within ``tests/test_fft.py``'s rtol, and the flags
   against the CPU run apart from bins within 1e-5 of their threshold
   (counted and printed), timed; ``FusedFlaggerTemplate`` (its forced
   search, then built from the shipped table without one) flag for flag
   ``flag_transposed`` (K1) on the seed-1 dump;
11. ``parallel`` on an NCCL process group of world size 1 (a ``TCPStore``
   on 127.0.0.1) over the seed-1 dump: ``make_sharded_fused_flagger`` on a
   (1,) baseline mesh (K1 through the mesh, with the launch counts set to
   0 just before and read just after) and ``make_sharded_flagger`` on a
   (1, 1) baseline x channel mesh (sum threshold, baseline_block 1008: the
   rank search's ``all_reduce`` rounds run, the halos only pad), each
   equal flag for flag to ``flag_dump`` (K1); ``get_flags_sharded`` on a
   (1,) mesh at config 1, equal to ``get_flags``; then the sharded K1
   against ``flag_dump`` interleaved, the stage flagger timed and the two
   2-D calls interleaved;
12. harnesses and support, each through its ``main`` at the reference's
   default size: ``scripts/transposetest --engine cuda`` (K5 on 3072 x
   8320 complex64 planar, the whole output against numpy's ``.T``),
   ``percentiletest --engine cuda`` (K4 on 4000 x 5000, exactly numpy's
   lower percentiles), ``maskedsumtest`` and ``maskedsumabstest`` (4000 x
   5000 complex64, within rtol 1e-4 / atol 1e-3 of numpy), each with the
   launch counts set to 0 just before and read just after, one call of K5's
   and of K4's under ``torch.profiler`` in a process of its own (one
   kernel each), and each time
   beside its byte bound; ``tune_all`` into
   ``build/katsdpsigproc_tpu_torch/tuning_table.json``, each pick beside
   the shipped record; ``utils/regions`` on CUDA tensors (a 3072 x 8320
   complex64 region copied, read and written, bit for bit numpy's); and
   the ``test.test_accel`` decorators ``device_test`` and ``cuda_test``
   resolving to ``cuda:0``;
13. one dump of the benchmark's ``l32k-fullflags`` cell, 32768 channels x
   8064 rows with the per-sample flags its loop makes from the seed
   (``flagbench/loops/fullflags.py``): ``flag_dump(vis.transpose(0, 1),
   flags.transpose(0, 1), flag_value=16)`` (K5 turns both, K1 in FULL
   mode) flag for flag ``flagbench/reference_ingest.py``, with one K1
   launch in FULL mode (``k1_modes``) and two of K5; then K1's FULL mode
   and K5's 1-byte turn of the flags timed each alone (CUDA events) beside
   their bounds (``flagbench/counts_ingest.py``), with K5's turn of the
   dump and the whole call;
14. the benchmark's ``l32k-hybrid`` cell, 32768 channels x 8064 rows from
   its seed (``flagbench/data.py``): each 1008-row slab, read where it lies
   in the dump, through the background kernel
   (``fused_flagger.background_deviations``, the general path) bit for
   bit the plain background and its turn
   (``background_deviations_plain``); the whole dump through the cell's
   ``make_flagger_fn(engine="hybrid", baseline_block=1008)``, one
   background and one K2 launch a slab, flag for flag
   ``flagbench/reference.py``; then, device-paced (``time_queued``), one
   slab's background kernel beside the plain background and turn it
   replaces, K2 and the flags' store, each beside its bound
   (``flagbench/counts_hybrid.py``), and the whole dump (CUDA events).

Any failure raises and exits non-zero before the result lines.  The
second-to-last line is a JSON record of each kernel, with its bound: the
larger of the bytes it must move (each input read once, each output
written once) over the HBM rate and its operations over the float32 rate
(:data:`HBM_BYTES_PER_S`, :data:`F32_OPS_PER_S`); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHANNELS, BASELINES, POLS = 32768, 2016, 4
# K1's widths beyond the 31 of earlier builds: both sides of
# ff.REGISTER_MAX_WIDTH (49), the run layout's in-place median near its
# widest (65) and one on the wide-row path.
WIDE_WIDTHS = (33, 35, 49, 51, 63, 101)
# The wide-row path's timed dump: 65536 channels x 2016 rows.
WIDE_CHANNELS, WIDE_ROWS = 65536, 2016
SOURCES = {
    "flagger": "katsdpsigproc_tpu_torch/csrc/fused_flagger.cu",
    "madnz_threshold": "katsdpsigproc_tpu_torch/csrc/fused_flagger.cu",
    "percentile5": "katsdpsigproc_tpu_torch/csrc/percentile.cu",
    "transpose": "katsdpsigproc_tpu_torch/csrc/transpose.cu",
    "stage_ablate": "katsdpsigproc_tpu_torch/csrc/flagger_probe.cu",
    "rankpair": "katsdpsigproc_tpu_torch/csrc/flagger_probe.cu",
    "rollchain": "katsdpsigproc_tpu_torch/csrc/flagger_probe.cu",
    "deinterleave": "katsdpsigproc_tpu_torch/csrc/flagger_probe.cu",
    "triple": "katsdpsigproc_tpu_torch/examples/triple_pallas.py",
    "multiply": "katsdpsigproc_tpu_torch/csrc/examples.cu",
    "prim_cost": "katsdpsigproc_tpu_torch/csrc/prim_cost.cu",
    "roofline_skeleton": "katsdpsigproc_tpu_torch/csrc/roofline_skeleton.cu",
    "box_filter": "katsdpsigproc_tpu_torch/csrc/box_filter.cu",
    "sum_threshold": "katsdpsigproc_tpu_torch/csrc/sum_threshold.cu",
    "masked_median": "katsdpsigproc_tpu_torch/csrc/masked_median.cu",
    "background": "katsdpsigproc_tpu_torch/csrc/fused_flagger.cu",
}
ROUTES = {"triple": "triton"}  # the others are CUDA C++
REPLACES = {
    "flagger": "katsdpsigproc_tpu/models/rfi/pallas_flagger.py:643",
    "madnz_threshold": "katsdpsigproc_tpu/models/rfi/pallas_flagger.py:762",
    "percentile5": "katsdpsigproc_tpu/ops/percentile.py:157",
    "transpose": "katsdpsigproc_tpu/ops/transpose.py:42",
    "stage_ablate": "scripts/stage_ablate.py:52",
    "rankpair": "scripts/rankpair_ab.py:47",
    "rollchain": "scripts/rollchain_ab.py:81",
    "deinterleave": "scripts/deinterleave_probe.py:41",
    "triple": "doc/examples/triple_pallas.py:23",
    "multiply": "doc/examples/triple.py:27",
    "prim_cost": "scripts/prim_cost.py:90",
    "roofline_skeleton": "scripts/roofline_skeleton.py:64",
    # No Pallas kernel: XLA's reduce_window computes the filter in JAX.
    "box_filter": "katsdpsigproc_tpu/models/rfi/twodflag.py:235",
    # No Pallas kernel: XLA computes SumThreshold's window chain in JAX.
    "sum_threshold": "katsdpsigproc_tpu/models/rfi/twodflag.py:291",
    # No Pallas kernel: XLA's bitwise rank search computes the medians in JAX.
    "masked_median": "katsdpsigproc_tpu/models/rfi/twodflag.py:50",
    # No Pallas kernel: XLA computes the hybrid engine's background pass in JAX.
    "background": "katsdpsigproc_tpu/models/rfi/device.py:218",
}
# The H100 SXM's HBM3 rate, and its float32 instruction rate outside the
# tensor cores.  The data sheet's 67 TFLOP/s (132 SMs x 128 lanes x 1.98
# GHz x 2) counts an FMA as two FLOPs; a min, max, compare or add is one
# instruction per lane per clock, so these operations run at half that,
# 33.5e12 a second.  Each counts as one operation.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12


def record(launches: int, ms: float, plain_ms: float, nbytes: float, ops: float,
           library_ms=None) -> dict:
    """A kernel's numbers, with its bound from the bytes and operations of this run's inputs."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def inventory_ops(stages=None) -> int:
    """The op inventory's operations per visibility (over `stages`, default all).

    The inventory is the least vector work of the exact flagger
    (``katsdpsigproc_tpu_torch/models/rfi/roofline.py::op_inventory``),
    the operation count of K1's bound.
    """
    from katsdpsigproc_tpu_torch.models.rfi.roofline import op_inventory

    return sum(count for stage, _, count in op_inventory() if stages is None or stage in stages)


def library_time(label: str, fn):
    """The time of one PyTorch call computing a kernel's function (None where torch refuses it)."""
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    try:
        ms = time_fn(fn)
    except RuntimeError as e:
        print(f"  library call {label}: refused at this size ({e})")
        return None
    print(f"  library call {label}: {ms:.3f} ms")
    return ms


class Check:
    """Kernel-against-plain comparisons, with the largest error per kernel."""

    def __init__(self):
        self.max_abs_err = {name: 0 for name in SOURCES}

    def exact(self, kernel: str, label: str, got, want) -> None:
        """Bit-for-bit equality of two tensors (NaN equal to NaN of the same bits)."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        g, w = got.contiguous(), want.contiguous()
        if g.is_complex():
            g, w = torch.view_as_real(g), torch.view_as_real(w)
        if g.dtype.is_floating_point:
            both = torch.isfinite(g) & torch.isfinite(w)
            err = float((g - w).abs()[both].max()) if bool(both.any()) else 0.0
            bits = {4: torch.int32, 8: torch.int64}[g.element_size()]
            g, w = g.view(bits), w.view(bits)
        else:
            err = float((g.to(torch.int16) - w.to(torch.int16)).abs().max()) if g.numel() else 0.0
        bad = int((g != w).sum())
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        print(f"  {label}: {bad} mismatching elements of {got.numel()}")
        if bad:
            raise AssertionError(f"{label}: {bad} mismatching elements")

    def close(self, kernel: str, label: str, got, want, rtol: float) -> None:
        """Equality within `rtol` of float32 tensors (inf equal to inf of the same sign)."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        both = torch.isfinite(got) & torch.isfinite(want)
        err = float((got - want).abs()[both].max()) if bool(both.any()) else 0.0
        bad = int((~both & (got != want)).sum()
                  + ((got - want).abs() > rtol * want.abs())[both].sum())
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        print(f"  {label}: {bad} elements of {got.numel()} beyond rtol {rtol} (max |err| {err:.3g})")
        if bad:
            raise AssertionError(f"{label}: {bad} elements beyond rtol {rtol}")

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


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    if not (ROOT / "katsdpsigproc_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: katsdpsigproc_tpu_torch/ is not beside this script; "
                 "run it from the root of a checkout")
    from katsdpsigproc_tpu_torch.scripts import common

    card = common.card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card)
    return card


def card_state(label: str) -> None:
    """The card's SM clock, power draw and temperature now, as nvidia-smi reads them."""
    from katsdpsigproc_tpu_torch.scripts import common

    print(f"  card state {label}: {common.card_state()}")


def ptxas_report(log: str) -> dict:
    """Per kernel in nvcc's -Xptxas -v output: registers, stack frame and spill bytes."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            report[name] = dict(zip(("stack", "spill_stores", "spill_loads"),
                                    map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in report:
            report[name]["registers"] = int(m.group(1))
    return report


def kernel_label(mangled: str) -> str:
    """K2's or K4's kernel name and template arguments from its mangled name in nvcc's report."""
    m = re.search(r"(percentile5_radix_kernel|madnz_threshold_kernel)"
                  r"(?:I((?:L[ib]n?\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = [a.replace("n", "-") for a in re.findall(r"L[ib](n?\d+)E", m.group(2) or "")]
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def phase_build(ff, pct, tr, fp, kernels) -> None:
    from katsdpsigproc_tpu_torch.examples import triple, triple_pallas
    from katsdpsigproc_tpu_torch.models.rfi import twodflag
    from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton

    def triton_kernel():
        """Triton compiles K6 at its first launch (into build/, TRITON_CACHE_DIR)."""
        t0 = time.perf_counter()
        triple_pallas.triple(torch.ones(triple_pallas.BLOCK, device="cuda"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        builds = [pool.submit(ff._library, 13), pool.submit(pct._library),
                  pool.submit(tr._library), pool.submit(fp._library, 13),
                  *(pool.submit(ff._library, w) for w in WIDE_WIDTHS),
                  pool.submit(triple._library), pool.submit(prim_cost._library),
                  pool.submit(roofline_skeleton._library, 13), pool.submit(twodflag._mm_library)]
        triton_s = pool.submit(triton_kernel)
        for b in builds:
            b.result()
        print(f"  triton: K6 compiled and launched in {triton_s.result():.1f} s")
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")
    for key, info in kernels.build_info.items():
        print(f"  {key}: nvcc {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  nvcc: {line.strip()}")
    # K1 at __launch_bounds__(kT, 1024 / kT) for each of its CTA sizes kT
    # (ff.K1_THREADS), a cap of 64 registers: no spills, at
    # width 13 and at each wide width built (the median's members in
    # registers up to ff.REGISTER_MAX_WIDTH, counted from memory above it),
    # on the run layout and on the wide-row path, and K2 on the wide-row
    # path.  Local memory beyond spills: an array indexed at run time (the
    # kernel parameters' copy for the window scales is one; SumThreshold's
    # chunk sums must not be).
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def k1_name(mangled: str):
        m = re.search(r"(flagger(?:_wide)?_kernel)ILi(\d)E(?:Li(\d+)E)?", mangled)
        if m:
            return f"{m.group(1)}<{', '.join(a for a in m.groups()[1:] if a)}>"
        return "madnz_threshold_wide_kernel" if "madnz_threshold_wide_kernel" in mangled else None

    for width in (13,) + WIDE_WIDTHS:
        k1_key = kernels.build_key("fused_flagger", ["fused_flagger.cu"],
                                   {"ff_network.h": ff._network_header(width)})
        k1 = {k1_name(name): r
              for name, r in ptxas_report(kernels.build_info[k1_key]["log"]).items()
              if k1_name(name)}
        sass = subprocess.run([cuobjdump, "-sass", str(kernels.BUILD_DIR / k1_key /
                                                       "libfused_flagger.so")],
                              capture_output=True, text=True).stdout
        local = {k1_name(part.split("\n")[0]): (len(re.findall(r"LDL", part)),
                                                len(re.findall(r"STL", part)))
                 for part in sass.split("Function : ")[1:] if k1_name(part.split("\n")[0])}
        median = "network" if width <= ff.REGISTER_MAX_WIDTH else "counted ranks"
        for name, r in sorted(k1.items()):
            lds, sts = local.get(name, (None, None))
            print(f"  K1 width {width} ({median}) {name}: {r.get('registers')} registers, "
                  f"{r['stack']} B stack frame, {r['spill_stores']} B spill stores, "
                  f"{r['spill_loads']} B spill loads; SASS {lds} local loads, {sts} local stores")
        # 3 flag modes at each CTA size, 3 on the wide-row path, K2's wide kernel
        if (len(k1) != 3 * len(ff.K1_THREADS) + 4
                or any(r["spill_stores"] or r["spill_loads"] for r in k1.values())):
            raise AssertionError(f"K1 at width {width} spills or is missing from the report: {k1}")
        # The background kernel: 6 general instances (3 flag modes x pairs or
        # amplitudes), the fast path and its fallback; no spills.
        bg = {name: r for name, r in ptxas_report(kernels.build_info[k1_key]["log"]).items()
              if "background_kernel" in name}
        print(f"  BG width {width} ({median}): {len(bg)} background_kernel instances, "
              f"{max((r.get('registers', 0) for r in bg.values()), default=None)} registers at "
              f"most, {sum(r['spill_stores'] + r['spill_loads'] for r in bg.values())} B spilled")
        if len(bg) != 8 or any(r["spill_stores"] or r["spill_loads"] for r in bg.values()):
            raise AssertionError(f"the background kernel at width {width} spills or is missing "
                                 f"from the report: {bg}")
        if width == 13:
            k1_13 = k1_key
    if ff._library(13).ff_max_in_place_width() != ff.IN_PLACE_MAX_WIDTH:
        raise AssertionError("the run layout's widest in-place median is not "
                             "ff.IN_PLACE_MAX_WIDTH")
    # K9, K11, K13 and `channel_major`, K1 with one stage replaced at K1's
    # launch bounds, K10 on K1's run layout and K12 at each cluster (1, 2, 4
    # and 8 rows): no spills, and their SASS's local loads and stores beside
    # K1's.
    fp_key = kernels.build_key("flagger_probe", ["flagger_probe.cu"],
                               {"ff_network.h": ff._network_header(13)})
    rs_key = kernels.build_key("roofline_skeleton", ["roofline_skeleton.cu"],
                               {"ff_network.h": ff._network_header(13)})

    names = {code: name for name, code in fp._CODE.items()}

    def probe_variant(mangled: str):
        m = re.search(r"probe_kernelILi(\d+)ELi(\d)E", mangled)
        if m:
            name = names[int(m.group(1))]
            return f"{name}<{m.group(2)}>" if name in fp.INPLACE else name
        layout = {"1": "channel-major", "0": "baseline-major"}
        m = re.search(r"amp_pairs_kernelILi(\d)ELb([01])E", mangled)
        if m:
            return f"amp_pairs<{m.group(1)}, {layout[m.group(2)]}>"
        return "skeleton_kernel" if "skeleton_kernel" in mangled else None

    reports, local = {}, {}
    for key, lib in ((fp_key, "libflagger_probe.so"), (rs_key, "libroofline_skeleton.so")):
        reports.update({probe_variant(name): r
                        for name, r in ptxas_report(kernels.build_info[key]["log"]).items()
                        if probe_variant(name)})
        sass = subprocess.run([cuobjdump, "-sass", str(kernels.BUILD_DIR / key / lib)],
                              capture_output=True, text=True).stdout
        local.update({probe_variant(part.split("\n")[0]): (len(re.findall(r"LDL", part)),
                                                           len(re.findall(r"STL", part)))
                      for part in sass.split("Function : ")[1:]})
    probe_id = {v: kid for kid, probe in (("K11", "stage_ablate"), ("K13", "rankpair"),
                                          ("K9", "rollchain"), ("K12", "deinterleave"))
                for v in fp.PROBES[probe]}
    k12 = [f"amp_pairs<{g}, channel-major>" for g in fp.CLUSTERS] + ["amp_pairs<1, baseline-major>"]
    inplace = tuple(f"{v}<{g}>" for v in fp.INPLACE for g in fp.CLUSTERS)
    checked = (tuple(v for v in fp.VARIANTS if v not in fp.INPLACE) + inplace
               + ("skeleton_kernel",) + tuple(k12))
    for v in checked:
        r = reports.get(v, {})
        lds, sts = local.get(v, (None, None))
        label = ("K10 skeleton_kernel" if v == "skeleton_kernel" else f"K12 {v}" if v in k12
                 else f"K12 probe_kernel<{v}>" if v in inplace
                 else f"{probe_id.get(v, 'K13')} probe_kernel<{v}>")
        print(f"  {label}: {r.get('registers')} registers, {r.get('stack')} B stack frame, "
              f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B spill loads; "
              f"SASS {lds} local loads, {sts} local stores")
    if (set(checked) - set(reports)
            or any(reports[v]["spill_stores"] or reports[v]["spill_loads"] for v in checked)):
        raise AssertionError(f"a K9, K10, K11, K12 or K13 instance spills or is missing from "
                             f"the report: {reports}")
    # K2 and every instance of K4: no spills either.
    pct_key = kernels.build_key("percentile", ["percentile.cu"], {})
    report = {kernel_label(name): r for key in (k1_13, pct_key)
              for name, r in ptxas_report(kernels.build_info[key]["log"]).items()
              if "madnz_threshold" in name or "percentile5" in name}
    for name, r in sorted(report.items()):
        print(f"  {name}: {r.get('registers')} registers, {r['stack']} B stack frame, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    checked = {name: r for name, r in report.items()
               if name == "madnz_threshold_kernel" or name.startswith("percentile5_radix")}
    if ("madnz_threshold_kernel" not in checked or len(checked) < 2
            or any(r["spill_stores"] or r["spill_loads"] for r in checked.values())):
        raise AssertionError(f"K2 or K4 spills or is missing from the report: {checked}")
    # The 2-D flagger's median kernels (masked_median_kernel: the line and
    # the block kernels): no spills, no local loads or stores.
    mm_key = kernels.build_key("masked_median", ["masked_median.cu"], {})
    report = {name: r for name, r in ptxas_report(kernels.build_info[mm_key]["log"]).items()
              if "median_" in name}
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.BUILD_DIR / mm_key /
                                                   "libmasked_median.so")],
                          capture_output=True, text=True).stdout
    local = len(re.findall(r"\b(?:LDL|STL)\b", sass))
    for name, r in sorted(report.items()):
        print(f"  masked_median_kernel {name}: {r.get('registers')} registers, {r['stack']} B "
              f"stack frame, {r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    print(f"  masked_median_kernel: SASS {local} local loads and stores in all")
    if len(report) != 3 or local or any(r["spill_stores"] or r["spill_loads"]
                                        for r in report.values()):
        raise AssertionError(f"the median kernels spill, use local memory or are missing from "
                             f"the report: {report}, {local} LDL/STL")
    # K8 at K1's launch, __launch_bounds__(1024, 1) as K1: no spills; and the
    # SASS instructions one rep of each body costs an element: the kernel
    # unrolled 16 times less 8 times, 8 reps (16 for rank_round and reduce,
    # which peel rep 0) of 8 elements (32 for the bodies on a whole run),
    # behind models/rfi/roofline.DEFAULT_PRIM_NS.
    pc_key = kernels.build_key("prim_cost", ["prim_cost.cu"],
                               {"ff_network.h": ff._network_header(13)})
    k8_names = {spec[3]: name for name, spec in prim_cost.ALL_BODIES.items()}
    k8_names[0] = "empty"

    def k8_kernel(mangled: str):
        m = re.search(r"k1_prim_kernelILi(\d+)ELi(\d+)E", mangled)
        return (k8_names[int(m.group(1))], int(m.group(2))) if m else None

    report = {k8_kernel(name): r
              for name, r in ptxas_report(kernels.build_info[pc_key]["log"]).items()
              if k8_kernel(name)}
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.BUILD_DIR / pc_key / "libprim_cost.so")],
                          capture_output=True, text=True).stdout
    opcodes = {}
    for part in sass.split("Function : ")[1:]:
        key = k8_kernel(part.split("\n")[0])
        if key:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", part)
            opcodes[key] = {op: ops.count(op) for op in set(ops)}
    spills = {k: r for k, r in report.items() if r["spill_stores"] or r["spill_loads"]}
    print(f"  K8 at K1's launch: {len(report)} k1_prim_kernel instances, "
          f"{max((r.get('registers', 0) for r in report.values()), default=None)} registers at "
          f"most, {len(spills)} spilling")
    if len(report) != 5 * len(k8_names) or spills:
        raise AssertionError(f"K8 at K1's launch spills or is missing from the report: {spills}")
    for name in k8_names.values():
        if name == "empty" or (name, 8) not in opcodes or (name, 16) not in opcodes:
            continue
        per = {"rank_round": 16 * 32, "reduce": 16 * 32, "shift_ch": 8 * 32,
               "roll_lane": 8 * 32}.get(name, 8 * 8)
        a, b = opcodes[(name, 16)], opcodes[(name, 8)]
        diff = {op: (a.get(op, 0) - b.get(op, 0)) / per for op in set(a) | set(b)}
        print(f"  K8 {name} at K1's launch: {report[(name, 16)].get('registers')} registers "
              f"(unroll 16); SASS a rep an element: {sum(diff.values()):.2f} instructions ("
              + ", ".join(f"{op} {n:.2f}" for op, n in sorted(diff.items()) if abs(n) >= 0.01)
              + ")")
    print(f"  K1 and K2 take rows of up to {ff.max_channels()} channels on the run layout, "
          f"longer ones on the wide-row path ({ff._library(13).ff_wide_ctas()} CTAs)")


def phase_kernels(ff, device, check: Check) -> None:
    from katsdpsigproc_tpu_torch.scripts import common

    print("kernels against their plain versions on the card:")
    # K1's run layout, which K2 now shares, gives each thread R = ceil(C /
    # 1024) channels: runs shorter than a window (C <= 4096), a last run
    # cut short (1025, 4097), runs of 32 (32768) and the channel limit.
    limit = ff.max_channels()
    cases = [(1, 8), (13, 8), (99, 8), (128, 16), (257, 8), (300, 8), (384, 8), (1023, 8),
             (1024, 8), (1025, 8), (4097, 8), (32768, 64), (limit, 4)]
    for i, (channels, rows) in enumerate(cases):
        vis, flags = test_dump(channels, rows, seed=100 + i)
        vis_t = torch.from_numpy(device.to_planar(vis.T).copy()).cuda()  # (rows, C, 2)
        flags_t = torch.from_numpy(flags.T.copy()).cuda()
        chan = torch.from_numpy(flags[:, 0].copy()).cuda()
        variants = [(mode, fkw, pkw)
                    for mode, fkw in (("none", {}), ("full", {"input_flags": flags_t}),
                                      ("channel", {"channel_flags": chan}))
                    for pkw in ({}, {"n_windows": 6, "flag_value": 3})]
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
        # K2 on deviations K1 never makes, against the plain version.
        dev_t = torch.from_numpy(common.adversarial_deviations(8, channels, 400 + i)).cuda()
        for pkw in ({}, {"n_sigma": 5.0, "n_windows": 6, "flag_value": 3}):
            label = f"K2 C={channels} NaN, +-inf, -0, denormal, zero rows {pkw or ''}".rstrip()
            check.flags("madnz_threshold", label, ff.madnz_threshold(dev_t, **pkw),
                        ff.madnz_threshold_plain(dev_t, **pkw))
    # NaN in a row: both the kernel and the plain fast path propagate it
    # through the selection network as jnp.minimum/maximum do.
    for channels in (300, 1025, 32768):
        vis, _ = test_dump(channels, 8, seed=200)
        vis[[5, 150, channels - 1], 2] = np.nan
        vis[0, 3] = np.nan + 0j
        vis_t = torch.from_numpy(device.to_planar(vis.T).copy()).cuda()
        for pkw in ({}, {"n_windows": 6}):
            check.flags("flagger", f"K1 NaN rows C={channels} {pkw or ''}".rstrip(),
                        ff.flag_transposed(vis_t, **pkw), ff.flag_transposed_plain(vis_t, **pkw))
    # The wide-row path: rows longer than the run layout holds (just past its
    # limit, 65536 and 65537 channels, 131072), every flag mode, a NaN in a
    # row; K2 on the same rows' deviations and on deviations K1 never makes.
    for name in ff.wide_launches:
        ff.wide_launches[name] = 0
    for channels in (limit + 1, 65536, 65537, 131072):
        vis, flags = test_dump(channels, 3, seed=channels % 997)
        vis_t = torch.from_numpy(device.to_planar(vis.T).copy()).cuda()  # (rows, C, 2)
        flags_t = torch.from_numpy(flags.T.copy()).cuda()
        chan = torch.from_numpy(flags[:, 0].copy()).cuda()
        vis_nan = vis_t.clone()
        vis_nan[1, channels // 2, 0] = float("nan")  # without input flags, as above
        for mode, x, fkw in (("none", vis_nan, {}), ("full", vis_t, {"input_flags": flags_t}),
                             ("channel", vis_t, {"channel_flags": chan})):
            for pkw in ({}, {"n_windows": 6, "flag_value": 3}):
                check.flags("flagger", f"K1 wide row C={channels} {mode} {pkw or ''}".rstrip(),
                            ff.flag_transposed(x, **fkw, **pkw),
                            ff.flag_transposed_plain(x, **fkw, **pkw))
        dev_t = device.background_median_filter(
            vis_t.transpose(0, 1), None, 13, False,
            device.BackgroundFlags.NONE).transpose(0, 1).contiguous()
        adversarial = torch.from_numpy(common.adversarial_deviations(8, channels, 500)).cuda()
        for label, d in (("deviations", dev_t), ("NaN, +-inf, -0, denormal, zero rows",
                                                 adversarial)):
            for pkw in ({}, {"n_sigma": 5.0, "n_windows": 6, "flag_value": 3}):
                check.flags("madnz_threshold", f"K2 wide row C={channels} {label} {pkw or ''}"
                            .rstrip(), ff.madnz_threshold(d, **pkw),
                            ff.madnz_threshold_plain(d, **pkw))
    # Windows wider than 31: the network over registers up to
    # ff.REGISTER_MAX_WIDTH, ranks counted from shared memory up to
    # ff.IN_PLACE_MAX_WIDTH, the wide-row path beyond; rows shorter than a
    # window (40), a last run cut short (1025, 4097), a NaN.
    for width in WIDE_WIDTHS:
        for channels in (40, 1025, 4097):
            vis, flags = test_dump(channels, 4, seed=width + channels)
            vis_t = torch.from_numpy(device.to_planar(vis.T).copy()).cuda()
            flags_t = torch.from_numpy(flags.T.copy()).cuda()
            chan = torch.from_numpy(flags[:, 0].copy()).cuda()
            vis_nan = vis_t.clone()
            if channels >= width:  # NaN through the fast median only, as above
                vis_nan[3, channels // 3, 0] = float("nan")
            for mode, x, fkw in (("none", vis_nan, {}), ("full", vis_t, {"input_flags": flags_t}),
                                 ("channel", vis_t, {"channel_flags": chan})):
                check.flags("flagger", f"K1 width {width} C={channels} {mode}",
                            ff.flag_transposed(x, width=width, **fkw),
                            ff.flag_transposed_plain(x, width=width, **fkw))
    torch.cuda.synchronize()
    print(f"  launches on the wide-row path: {dict(ff.wide_launches)}")
    if min(ff.wide_launches.values()) < 1:
        raise AssertionError("the wide-row path was not launched")


def phase_wide(ff, device, card: str, check: Check) -> dict:
    """K1 and K2 on the wide-row path over a dump of WIDE_CHANNELS x WIDE_ROWS."""
    from katsdpsigproc_tpu_torch.scripts.common import deviations, meerkat_dump
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    t0 = time.perf_counter()
    vis = torch.from_numpy(device.to_planar(meerkat_dump(WIDE_CHANNELS, WIDE_ROWS))).cuda()
    print(f"the wide-row path on the seed-1 dump of {WIDE_CHANNELS} channels x {WIDE_ROWS} rows "
          f"({vis.numel() * 4 / 1e9:.2f} GB planar, made in {time.perf_counter() - t0:.1f} s):")
    vis_t = vis.transpose(0, 1).contiguous()
    dev_t = deviations(vis, 504)
    del vis
    for name in ff.wide_launches:
        ff.wide_launches[name] = 0
    k1 = ff.flag_dump(vis_t)
    k2 = ff.madnz_threshold(dev_t)
    torch.cuda.synchronize()
    launches = dict(ff.wide_launches)
    print(f"  launches on the wide-row path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError("the wide-row path was not launched on the wide dump")

    def slabs(fn, x):
        def run():
            out = torch.empty((WIDE_ROWS, WIDE_CHANNELS), dtype=torch.uint8, device=x.device)
            for s in range(0, WIDE_ROWS, 504):
                out[s:s + 504] = fn(x[s:s + 504])
            return out
        return run

    plain_k1 = slabs(ff.flag_transposed_plain, vis_t)
    plain_k2 = slabs(ff.madnz_threshold_plain, dev_t)
    check.flags("flagger", "wide dump: K1 (wide-row path) vs plain", k1, plain_k1())
    check.flags("madnz_threshold", "wide dump: K2 (wide-row path) vs plain", k2, plain_k2())
    check.flags("madnz_threshold", "wide dump: K2 vs K1", k2, k1)
    print(f"  flagged fraction {float(k1.float().mean()):.5f}")
    del k1, k2
    card_state("before the wide-row path's timings")
    times = {"flagger": time_fn(lambda: ff.flag_dump(vis_t), warmup=1, iters=5),
             "madnz_threshold": time_fn(lambda: ff.madnz_threshold(dev_t), warmup=1, iters=5)}
    plain = {"flagger": time_fn(plain_k1, warmup=1, iters=3),
             "madnz_threshold": time_fn(plain_k2, warmup=1, iters=3)}
    card_state("after them")
    n_vis = WIDE_CHANNELS * WIDE_ROWS
    out = {}
    for name, nbytes, stages in (("flagger", 9, None),
                                 ("madnz_threshold", 5, ("rank", "threshold", "output"))):
        bound = max(nbytes * n_vis / HBM_BYTES_PER_S, inventory_ops(stages) * n_vis
                    / F32_OPS_PER_S) * 1e3
        print(f"  {name} on the wide-row path: {times[name]:.3f} ms "
              f"({n_vis / times[name] / 1e6:.3f} Gvis/s) against its bound {bound:.3f} ms; "
              f"plain {plain[name]:.3f} ms [{card}]")
        out[name] = {"channels": WIDE_CHANNELS, "rows": WIDE_ROWS, "launches": launches[name],
                     "ms": times[name], "plain_ms": plain[name], "bound_ms": bound}
    return out


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


def phase_main(ff, tr, device, vis_np: np.ndarray, card: str, check: Check) -> dict:
    from katsdpsigproc_tpu_torch.scripts.common import deviations
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    rows = vis_np.shape[1]
    n_vis = vis_np.size
    print(f"main path: {vis_np.shape[0]} channels x {rows} rows")
    vis = torch.from_numpy(device.to_planar(vis_np)).cuda()  # (C, rows, 2), channel-major
    block = 1008
    hybrid_fn = device.make_flagger_fn(13, 11.0, engine="hybrid", baseline_block=block)
    hybrid_fast_fn = device.make_flagger_fn(13, 11.0, engine="hybrid", baseline_block=block,
                                            background_fast=True)
    # The JAX package's (2, rows, channels) input form, copied on the card.
    vis_leading = vis.permute(2, 1, 0).contiguous()

    # The bench's call, flag_dump(swapaxes(v, 0, 1)): K5 turns the view, K1
    # flags; the same through flag_transposed_dma, on the view and on the
    # leading copy; the hybrid engine on its general and its fast background.
    for name in ff.launches:
        ff.launches[name] = 0
    tr.launches["transpose"] = 0
    k1 = ff.flag_dump(vis.transpose(0, 1))  # (rows, C)
    k1_dma = ff.flag_transposed_dma(vis.transpose(0, 1))
    k1_leading = ff.flag_transposed_dma(vis_leading, layout="leading")
    hybrid = hybrid_fn(vis)  # (C, rows)
    hybrid_fast = hybrid_fast_fn(vis)
    torch.cuda.synchronize()
    launches = dict(ff.launches, transpose=tr.launches["transpose"])
    print(f"  launches during the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    # One K1 launch per flag_dump and flag_transposed_dma call, one background
    # and one K2 launch per block of each hybrid call; K5 turns the two views,
    # not the leading copy.
    want = {"flagger": 3, "madnz_threshold": 2 * -(-rows // block),
            "background": 2 * -(-rows // block), "transpose": 2}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    check.flags("flagger", "full dump: flag_transposed_dma (K5 + K1) vs flag_dump's K1",
                k1_dma, k1)
    check.flags("flagger", "full dump: flag_transposed_dma(layout='leading') vs flag_dump's K1",
                k1_leading, k1)
    check.flags("madnz_threshold",
                "full dump: hybrid with background_fast=True vs its general path",
                hybrid_fast, hybrid)
    del k1_dma, k1_leading, hybrid_fast

    vis_t = vis.transpose(0, 1).contiguous()

    def plain_k1():
        out = torch.empty((rows, vis.shape[0]), dtype=torch.uint8, device=vis.device)
        for s in range(0, rows, 2 * block):
            out[s:s + 2 * block] = ff.flag_transposed_plain(vis_t[s:s + 2 * block])
        return out

    plain = plain_k1()
    if not (k1.shape == plain.shape and set(k1.unique().tolist()) <= {0, 1}):
        raise AssertionError(f"unexpected K1 output {k1.shape} {k1.unique().tolist()}")
    check.flags("flagger", "full dump: K5 + K1 (flag_dump of the view) vs plain", k1, plain)
    # The 4k mode's dump, the first 4096 channels of each row: K5 + K1 in the
    # CTA the rule picks (128 threads, 8 rows to an SM) against the plain version.
    vis_4k = vis[:4096]
    before = dict(ff.k1_ctas)
    k1_4k = ff.flag_dump(vis_4k.transpose(0, 1))
    torch.cuda.synchronize()
    threads = ff.k1_threads(4096)
    if ff.k1_ctas[threads] != before[threads] + 1:
        raise AssertionError(f"K1 at 4096 channels did not launch {threads} threads: "
                             f"{ff.k1_ctas} after {before}")
    vis_4k_t = vis_4k.transpose(0, 1).contiguous()
    plain_4k = torch.cat([ff.flag_transposed_plain(vis_4k_t[s:s + 2 * block])
                          for s in range(0, rows, 2 * block)])
    check.flags("flagger", f"4096 x {rows}: K5 + K1 ({threads}-thread CTAs) vs plain", k1_4k,
                plain_4k)
    del vis_4k_t, plain_4k, k1_4k
    check.flags("flagger", "full dump: K1 on the contiguous dump vs K5 + K1", ff.flag_dump(vis_t),
                k1)
    check.flags("madnz_threshold", "full dump: hybrid (K2) vs K1", hybrid.T, k1)
    print(f"  flagged fraction {float(k1.float().mean()):.5f}")

    # K2 against its plain version and K1 on the full dump's deviations.
    dev_t = deviations(vis, block)
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
    card_state("before the main path's timings")
    times = {
        "K1 flag_dump, corner turn excluded": time_fn(lambda: ff.flag_dump(vis_t)),
        "K5 + K1 flag_dump(vis.transpose(0, 1)), the bench's call": time_fn(
            lambda: ff.flag_dump(vis.transpose(0, 1))),
        "plain corner turn + K1 flag_dump": time_fn(
            lambda: ff.flag_dump(vis.transpose(0, 1).contiguous())),
        "K1 plain (flag_transposed_plain)": time_fn(plain_k1),
        "hybrid engine (background kernel + K2)": time_fn(lambda: hybrid_fn(vis)),
        "hybrid engine, background_fast=True (the kernel's fast path + K2)": time_fn(
            lambda: hybrid_fast_fn(vis)),
        "K1 flag_transposed_dma(layout='leading'), copy to rows included": time_fn(
            lambda: ff.flag_transposed_dma(vis_leading, layout="leading")),
        "K2 madnz_threshold": time_fn(lambda: ff.madnz_threshold(dev_t)),
        "K2 plain (madnz_threshold_plain)": time_fn(plain_k2),
    }
    card_state("after them")
    for name, ms in times.items():
        print(f"  {name}: {ms:.3f} ms, {n_vis / ms / 1e6:.3f} Gvis/s [{card}]")
    # K1 reads 8 B and writes 1 B per visibility and does the op inventory's
    # work; K2 reads 4 B of deviations, writes 1 B and does its back half.
    return {
        "flagger": record(launches["flagger"], times["K1 flag_dump, corner turn excluded"],
                          times["K1 plain (flag_transposed_plain)"], 9 * n_vis,
                          inventory_ops() * n_vis),
        "madnz_threshold": record(launches["madnz_threshold"], times["K2 madnz_threshold"],
                                  times["K2 plain (madnz_threshold_plain)"], 5 * n_vis,
                                  inventory_ops(("rank", "threshold", "output")) * n_vis),
    }


def plain_ops_check(label: str, got, want: np.ndarray, rtol: float, atol: float) -> None:
    """A plain op on the card against numpy float64, within the JAX tests' tolerance."""
    got = got.cpu().numpy()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} vs {want.shape}")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    print(f"  {label}: max |err| {err:.3g} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def phase_ops(pct, tr, vis_np: np.ndarray, card: str, check: Check) -> dict:
    from katsdpsigproc_tpu_torch.models.rfi import device
    from katsdpsigproc_tpu_torch.ops import fill, maskedsum, reduce as hreduce, wgreduce
    from katsdpsigproc_tpu_torch.scripts import common
    from katsdpsigproc_tpu_torch.utils import backend, tune
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    ctx = backend.create_some_context()
    if ctx.device.type != "cuda":
        raise AssertionError(f"the context is on {ctx.device}, not CUDA")
    dev = ctx.device
    print(f"ops path on {ctx.device} ({ctx.device_kind}):")

    # K4 against its plain version, bit for bit.
    shared_cols = pct.max_shared_columns()
    print(f"  K4 holds rows of up to {shared_cols} columns' keys in shared memory")
    rs = np.random.RandomState(seed=1)
    cases = []
    for cols in (7, 241, 500):
        x = rs.uniform(0.01, 100.0, (37, cols)).astype(np.float32)
        x[3, ::3] = np.nan  # NaN is absent
        x[5] = np.nan  # an all-NaN row
        cases.append((f"37x{cols} with NaN rows", torch.from_numpy(x).to(dev)))
    cfg2 = torch.from_numpy(np.abs(np.random.RandomState(seed=1).standard_normal(
        (64, 4096))).astype(np.float32)).to(dev)
    big_np = np.abs(np.random.RandomState(seed=1).standard_normal((4000, 5000))).astype(np.float32)
    big = torch.from_numpy(big_np).to(dev)
    wide = torch.from_numpy(np.abs(rs.standard_normal((8, 65536))).astype(np.float32)).to(dev)
    if wide.shape[1] <= pct.max_shared_columns():
        raise AssertionError("the wide case no longer exceeds K4's shared memory")
    cases += [("64x4096 (bench config 2)", cfg2), ("4000x5000 (percentiletest)", big),
              ("4000x5000[:, 100:4100] column-range view", big[:, 100:4100]),
              ("4000x5000[:, 1:4998] view off 16 bytes", big[:, 1:4998]),
              ("8x65536, read from device memory every pass", wide)]
    # Rows K4 never sees on the ops path, below and above the SM count, and
    # the edges of its register, shared-memory and device-memory paths.
    for i, (rows, n) in enumerate([(20, 1), (20, 2), (20, 3), (20, 7), (20, 4096), (200, 5000),
                                   (200, 8192), (200, 8193), (20, 16384), (20, 16385),
                                   (4, shared_cols), (4, shared_cols + 1)]):
        x = torch.from_numpy(common.adversarial_rows(rows, n, seed=500 + i)).to(dev)
        cases.append((f"{rows}x{n} NaN, +-inf, -0, negative, denormal, equal rows", x))
    for label, x in cases:
        threads, per = pct.launch_shape(*x.shape)
        want = pct.percentile5_plain(x)
        check.exact("percentile5", f"K4 {label} ({threads} threads, {per} slots)",
                    pct.percentile5_cuda(x), want)
    expected = np.r_[[big_np.min(axis=1), big_np.max(axis=1)],
                     np.percentile(big_np, [25, 75, 50], axis=1, method="lower")].astype(np.float32)
    got = pct.percentile5_cuda(big).cpu().numpy()
    bad = int((got != expected).sum())
    print(f"  K4 4000x5000 vs np.percentile(method='lower'): {bad} mismatching elements")
    if bad:
        raise AssertionError("K4 disagrees with numpy's lower percentiles")

    # K5 against its plain version, bit for bit.
    for shape in ((53, 7), (73, 521), (130, 260)):
        for kind in ("float32", "uint8", "complex64", "planar"):
            if kind == "planar":
                x = rs.uniform(0, 100, shape + (2,)).astype(np.float32)
            elif kind == "complex64":
                x = rs.standard_normal(shape) + 1j * rs.standard_normal(shape)
                x = x.astype(np.complex64)
            else:
                x = rs.uniform(0, 100, shape).astype(kind)
            x = torch.from_numpy(x).to(dev)
            check.exact("transpose", f"K5 {kind} {shape}", tr.transpose_cuda(x),
                        tr.transpose_plain(x))
    cfg3_np = np.random.RandomState(seed=1).standard_normal((8192, 2016, 2)).astype(np.float32)
    cfg3 = torch.view_as_complex(torch.from_numpy(cfg3_np).to(dev))
    check.exact("transpose", "K5 complex64 8192x2016 (bench config 3)", tr.transpose_cuda(cfg3),
                tr.transpose_plain(cfg3))
    corner = torch.from_numpy(device.to_planar(vis_np)).to(dev)  # (32768, 8064, 2)
    check.exact("transpose", "K5 planar 32768x8064x2 (the main path's corner turn)",
                tr.transpose_cuda(corner), tr.transpose_plain(corner))

    # Plain ops against numpy float64 at the config 2 and 3 shapes.
    ms_src_np = (rs.standard_normal((4096, 64)) + 1j * rs.standard_normal((4096, 64))).astype(
        np.complex64)
    mask_np = rs.random_sample(4096).astype(np.float32)
    ms_src, mask = torch.from_numpy(ms_src_np).to(dev), torch.from_numpy(mask_np).to(dev)
    for amps in (False, True):
        op = maskedsum.MaskedSumTemplate(ctx, amps).instantiate(None, (4096, 64))
        terms = ms_src_np.astype(np.complex128)
        terms = np.abs(terms) if amps else terms
        plain_ops_check(f"MaskedSum 4096x64 use_amplitudes={amps}",
                        op(src=ms_src, mask=mask)["dest"],
                        (mask_np[:, None] * terms).sum(axis=0), 1e-5, 1e-4)
    amp_np = np.hypot(cfg3_np[..., 0], cfg3_np[..., 1]).astype(np.float32)
    amp = torch.from_numpy(amp_np).to(dev)
    for name, np_fn in (("plus", np.sum), ("max", np.max), ("min", np.min)):
        op = hreduce.HReduceTemplate(ctx, np.float32, op=name).instantiate(
            None, amp.shape, (7, 2000))
        plain_ops_check(f"HReduce {name} 8192x2016[:, 7:2000]", op(src=amp)["dest"],
                        np_fn(amp_np[:, 7:2000].astype(np.float64), axis=1), 1e-5, 1e-4)
    for dtype, shape in ((np.float32, (64, 4096)), (np.complex64, (8192, 2016))):
        op = fill.FillTemplate(ctx, dtype).instantiate(None, shape)
        op.set_value(4)
        op.ensure_all_bound()
        op()
        plain_ops_check(f"Fill {np.dtype(dtype).name} {shape}", op.buffer("data"),
                        np.full(shape, 4, np.float64), 0, 0)

    # One forced tuner search per autotuned template; the picks are the
    # H100 records of the port's tuning table.
    print("forced tuner searches:")
    picks = {}
    saved = tune.autotuner_impl
    tune.autotuner_impl = tune.force_autotuner
    try:
        for label, make in (
                ("Percentile5Template(5000, True)",
                 lambda: pct.Percentile5Template(ctx, 5000, True)),
                ("TransposeTemplate(complex64)",
                 lambda: tr.TransposeTemplate(ctx, np.complex64)),
                ("TransposeTemplate(float32)", lambda: tr.TransposeTemplate(ctx, np.float32)),
                ("BackgroundMedianFilterDeviceTemplate(13)",
                 lambda: device.BackgroundMedianFilterDeviceTemplate(ctx, 13)),
                ("NoiseEstMADTDeviceTemplate(32768)",
                 lambda: device.NoiseEstMADTDeviceTemplate(ctx, 32768)),
                ("NoiseEstMADDeviceTemplate()", lambda: device.NoiseEstMADDeviceTemplate(ctx))):
            t0 = time.perf_counter()
            tmpl = make()
            picks[label] = {k: getattr(tmpl, k) for k in ("engine", "radix_bits")
                            if hasattr(tmpl, k)}
            print(f"  {label}: {picks[label]} ({time.perf_counter() - t0:.1f} s)")
    finally:
        tune.autotuner_impl = saved
    print(f"  tuning picks on {ctx.device_kind}: {json.dumps(picks, sort_keys=True)}")

    # Both Operation call styles.
    k4 = pct.Percentile5Template(ctx, 5000, True, tuning={"engine": "cuda"})
    op = k4.instantiate(None, tuple(big.shape), (100, 4100))
    functional = op(src=big)["dest"]
    op.bind(src=big)
    op()
    check.exact("percentile5", "Percentile5 op, bound vs functional call", op.buffer("dest"),
                functional)
    check.exact("percentile5", "Percentile5 op column_range vs K4 on the view", functional,
                pct.percentile5_cuda(big[:, 100:4100]))
    k5 = tr.TransposeTemplate(ctx, np.complex64, tuning={"engine": "cuda"})
    op = k5.instantiate(None, tuple(cfg3.shape))
    op.bind(src=cfg3)
    op()
    check.exact("transpose", "Transpose op, bound vs functional call", op.buffer("dest"),
                op(src=cfg3)["dest"])

    # The ops path: configs 2 and 3 and the percentiletest run through the
    # templates, with the launch counts set to 0 just before and read just after.
    ms_planar = torch.view_as_real(ms_src)
    pct.launches["percentile5"] = 0
    tr.launches["transpose"] = 0
    pct_op = k4.instantiate(None, tuple(cfg2.shape))
    out2 = pct_op(src=cfg2)["dest"]
    summed = maskedsum.maskedsum(ms_planar, mask)
    big_out = k4.instantiate(None, tuple(big.shape))(src=big)["dest"]
    planar3 = torch.view_as_real(cfg3)  # bench config 3 turns the planar pairs
    turned = tr.transpose(planar3, k5)
    rowsum = wgreduce.reduce(amp, wgreduce.plus, axis=1)
    torch.cuda.synchronize()
    launches = {"percentile5": pct.launches["percentile5"], "transpose": tr.launches["transpose"]}
    print(f"  launches during the ops path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the ops path")
    for label, t, shape in (("percentile5 64x4096", out2, (5, 64)),
                            ("maskedsum 4096x64", summed, (64, 2)),
                            ("percentile5 4000x5000", big_out, (5, 4000)),
                            ("transpose 8192x2016x2", turned, (2016, 8192, 2)),
                            ("hreduce 8192x2016", rowsum, (8192,))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: shape {tuple(t.shape)} or non-finite values")
    if not torch.equal(big_out.cpu(), torch.from_numpy(expected)):
        raise AssertionError("the ops path's 4000x5000 percentiles disagree with numpy")
    if not torch.equal(turned, planar3.transpose(0, 1)):
        raise AssertionError("the ops path's corner turn disagrees")

    print(f"timings (CUDA events, 2 warm-ups, median of 10) on {card}:")
    times = {
        "K4 percentile5 4000x5000": time_fn(lambda: pct.percentile5_cuda(big)),
        "K4 plain 4000x5000": time_fn(lambda: pct.percentile5_plain(big)),
        "K4 percentile5 64x4096": time_fn(lambda: pct.percentile5_cuda(cfg2)),
        "K4 plain 64x4096": time_fn(lambda: pct.percentile5_plain(cfg2)),
        "K5 transpose 32768x8064x2": time_fn(lambda: tr.transpose_cuda(corner)),
        "K5 plain 32768x8064x2": time_fn(lambda: tr.transpose_plain(corner)),
        "K5 transpose c64 8192x2016": time_fn(lambda: tr.transpose_cuda(cfg3)),
        "K5 plain c64 8192x2016": time_fn(lambda: tr.transpose_plain(cfg3)),
        "rank engine 4000x5000": time_fn(lambda: pct.percentile5(big, "rank")),
        "sort engine 4000x5000": time_fn(lambda: pct.percentile5(big, "sort")),
    }
    library = {
        "percentile5": library_time(
            "torch.quantile(x, [0, .25, .5, .75, 1], dim=1, interpolation='lower') 4000x5000",
            lambda: common.quantile(big)),
        "percentile5 64x4096": library_time(
            "torch.quantile(x, [0, .25, .5, .75, 1], dim=1, interpolation='lower') 64x4096",
            lambda: common.quantile(cfg2)),
        "transpose": library_time("corner.transpose(0, 1).contiguous() 32768x8064x2",
                                  lambda: corner.transpose(0, 1).contiguous()),
    }
    for name, ms in times.items():
        print(f"  {name}: {ms:.3f} ms [{card}]")
    corner_bytes = 2 * corner.numel() * corner.element_size()
    print(f"  K5 corner turn: {corner_bytes / times['K5 transpose 32768x8064x2'] / 1e6:.1f} GB/s "
          f"of {corner_bytes / 1e9:.2f} GB moved [{card}]")
    # K4 reads each element once and writes 5 floats a row.  Its radix
    # select does 14 operations an element (min, max, the key's compare and
    # select, the first pass's count, a prefix compare per target in each
    # of three passes) and scans 256 + 3 x (256 + 256 + 128) bins a row;
    # the original 31-round search did 2 + 31 x 3 x 2.  K5 reads and writes every
    # byte once.
    def k4_work(x):
        rows = x.shape[0]
        return (x.numel() * 4 + 5 * rows * 4,
                x.numel() * 14 + rows * (256 + 3 * (256 + 256 + 128)))

    for label, x in (("4000x5000", big), ("64x4096", cfg2)):
        nbytes, ops = k4_work(x)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        print(f"  K4 bound at {label}: bytes {bytes_ms:.5f} ms, operations {ops_ms:.5f} ms: "
              f"{'bytes' if bytes_ms >= ops_ms else 'operations'} bind; the 31-round search's "
              f"operations {x.numel() * (2 + 31 * 3 * 2) / F32_OPS_PER_S * 1e3:.5f} ms")
    return {
        "percentile5": record(launches["percentile5"], times["K4 percentile5 4000x5000"],
                              times["K4 plain 4000x5000"], *k4_work(big),
                              library["percentile5"]),
        "transpose": record(launches["transpose"], times["K5 transpose 32768x8064x2"],
                            times["K5 plain 32768x8064x2"], corner_bytes, 0,
                            library["transpose"]),
    }


def phase_flagger_device(ff, vis_np: np.ndarray, card: str, check: Check) -> None:
    from katsdpsigproc_tpu_torch.models.rfi import device
    from katsdpsigproc_tpu_torch.utils import backend
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    ctx = backend.create_some_context()
    channels, rows = vis_np.shape
    print(f"FlaggerDevice on {channels} channels x {rows} rows, complex64:")
    template = device.FlaggerDeviceTemplate(
        device.BackgroundMedianFilterDeviceTemplate(ctx, 13),
        device.NoiseEstMADTDeviceTemplate(ctx),
        device.ThresholdSumDeviceTemplate(ctx))
    flagger = template.instantiate(None, channels, rows, threshold_args={"n_sigma": 11.0})
    print(f"  stages: {[name for name, _ in flagger.operations]}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vis = torch.from_numpy(vis_np).cuda()
    flags = flagger(vis=vis)["flags"]
    torch.cuda.synchronize()
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    vis_t = torch.view_as_real(vis).transpose(0, 1).contiguous()  # (rows, C, 2)
    k1 = ff.flag_transposed(vis_t, width=13, n_sigma=11.0)
    check.flags("flagger", "FlaggerDevice vs K1 on the same rows", flags.T.contiguous(), k1)
    ms = time_fn(lambda: flagger(vis=vis))
    print(f"  FlaggerDevice (plain stages, two corner turns): {ms:.3f} ms, "
          f"{vis.numel() / ms / 1e6:.3f} Gvis/s [{card}]")


def phase_probes(fp, ff, device, vis_np: np.ndarray, card: str, check: Check) -> dict:
    from katsdpsigproc_tpu_torch.scripts import (deinterleave_probe, rankpair_ab, rollchain_ab,
                                                 stage_ablate)
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    probe_of = {v: name for name, variants in fp.PROBES.items() for v in variants}
    channels, rows = vis_np.shape
    print("K1's stage probes (csrc/flagger_probe.cu):")

    # K9, K11, K13, `channel_major` and K12 launch as K1 does (the run
    # layout), as the libraries report it: 1024 threads, K1's dynamic
    # shared memory, one CTA per SM.
    k1_cfg = ff.launch_config(channels)
    for v in ("K1",) + fp.VARIANTS + ("amp_pairs",):
        cfg = k1_cfg if v == "K1" else fp.launch_config(v, channels)
        print(f"  launch {v} at {channels} channels: {cfg['threads']} threads, "
              f"{cfg['smem_bytes']} B dynamic shared memory, {cfg['ctas_per_sm']} CTA per SM")
        if cfg != k1_cfg:
            raise AssertionError(f"{v} does not launch as K1 does ({k1_cfg}): {cfg}")
    if k1_cfg["threads"] != 1024 or k1_cfg["ctas_per_sm"] != 1:
        raise AssertionError(f"K1 no longer launches 1024 threads, one CTA per SM: {k1_cfg}")
    # K12's channel-major read in clusters of rows, at K1's CTA: the
    # clusters that fit the card at once (132 SMs in GPCs of up to 18).
    for g in fp.CLUSTERS:
        cfg = fp.amp_launch_config(channels, channel_major=True, cluster=g)
        print(f"  launch K12 channel-major, clusters of {g} rows: {cfg['clusters']} clusters "
              f"({g * cfg['clusters']} CTAs) fit at once; {cfg['threads']} threads, "
              f"{cfg['smem_bytes']} B dynamic shared memory, {cfg['ctas_per_sm']} CTA per SM")
        if {k: cfg[k] for k in k1_cfg} != k1_cfg or (g > 1 and cfg["clusters"] < 1):
            raise AssertionError(f"K12's clusters of {g} do not launch at K1's CTA: {cfg}")

    # Every variant against its plain version, exact.
    cases = []
    for i, (c, r) in enumerate([(128, 16), (257, 8), (99, 8), (32768, 64)]):
        vis, _ = test_dump(c, r, seed=300 + i)
        cases.append((f"C={c} rows={r}", device.to_planar(vis.T)))
    cases.append(("seed-1 dump, 512 rows", device.to_planar(vis_np[:, :512].T)))
    for label, planar in cases:
        vis_t = torch.from_numpy(planar.copy()).cuda()  # (rows, C, 2)
        for v in fp.VARIANTS:
            check.flags(probe_of[v], f"{v} vs plain, {label}", fp.probe(vis_t, v),
                        fp.probe_plain(vis_t, v))
        vis_c = vis_t.transpose(0, 1).contiguous()
        want = fp.amp_pairs_plain(vis_t)
        check.exact("deinterleave", f"amp_pairs baseline-major vs plain, {label}",
                    fp.amp_pairs(vis_t), want)
        for g in fp.CLUSTERS:
            check.exact("deinterleave", f"amp_pairs channel-major, clusters of {g}, vs plain, "
                        f"{label}", fp.amp_pairs(vis_c, channel_major=True, cluster=g), want)

    # The whole dump: the bit-exact variants against K1, every stage_ablate
    # variant and radix_select against its plain version, K12 against the
    # plain amplitude.
    vis = torch.from_numpy(device.to_planar(vis_np)).cuda()  # (C, rows, 2), channel-major
    vis_t = vis.transpose(0, 1).contiguous()

    def slabs(fn):
        """`fn` over the whole dump in slabs of rows, to bound the plain versions' memory."""
        def run():
            out = torch.empty((rows, channels), dtype=torch.uint8, device=vis.device)
            for s in range(0, rows, 2016):
                out[s:s + 2016] = fn(vis_t[s:s + 2016])
            return out
        return run

    plain_fns = {v: slabs(lambda x, v=v: fp.probe_plain(x, v))
                 for v in fp.STAGE_ABLATE + ("radix_select",)}
    k1 = ff.flag_dump(vis_t)
    for v in fp.EXACT:
        if v not in fp.INPLACE:
            check.flags(probe_of[v], f"full dump: {v} vs K1", fp.probe(vis_t, v), k1)
    for g in fp.CLUSTERS:  # reading the channel-major dump in place
        check.flags("deinterleave", f"full dump: channel_major, clusters of {g}, vs K1",
                    fp.probe(vis.transpose(0, 1), "channel_major", cluster=g), k1)
    del k1
    for v, plain_fn in plain_fns.items():
        check.flags(probe_of[v], f"full dump: {v} vs plain", fp.probe(vis_t, v), plain_fn())
    amp = fp.amp_pairs_plain(vis_t)
    check.exact("deinterleave", "full dump: amp_pairs baseline-major vs plain",
                fp.amp_pairs(vis_t), amp)
    for g in fp.CLUSTERS:
        check.exact("deinterleave", f"full dump: amp_pairs channel-major, clusters of {g}, vs "
                    f"plain", fp.amp_pairs(vis, channel_major=True, cluster=g), amp)
    del amp
    # The library's call for K12's function on the channel-major dump: two
    # calls, the norm over the pair and the turn to rows.
    k12_library = library_time("torch.linalg.vector_norm(vis, dim=-1).t().contiguous() (two "
                               "calls)", lambda: torch.linalg.vector_norm(vis, dim=-1).t()
                               .contiguous())

    # The profiling path: the four probe tools on the whole dump, with the
    # launch counts set to 0 just before and read just after.
    print(f"the probe tools on the whole dump, interleaved, 5 rounds of 3 calls, on {card}:")
    for name in fp.launches:
        fp.launches[name] = 0
    for g in fp.cluster_launches:
        fp.cluster_launches[g] = 0
    stage_ms, stages = stage_ablate.run(vis_t, iters=3, reps=5, card=card)
    rank_ms, _ = rankpair_ab.run(vis_t, iters=3, reps=5, card=card)
    roll_ms = rollchain_ab.run(vis_t, iters=3, reps=5, card=card)
    dein_ms = deinterleave_probe.run(vis, iters=3, reps=5, card=card)
    torch.cuda.synchronize()
    card_state("after the probe tools")
    counts = {name: sum(fp.launches[v] for v in variants) for name, variants in fp.PROBES.items()}
    print(f"  launches during the profiling path: {dict(fp.launches)}; K12's channel-major "
          f"launches per cluster: {dict(fp.cluster_launches)}")
    for v, count in list(fp.launches.items()) + list(fp.cluster_launches.items()):
        if count < 1:
            raise AssertionError(f"probe kernel {v} was not launched on the profiling path")

    # The plain versions on the whole dump.
    plain = {v: time_fn(fn, warmup=1, iters=3) for v, fn in plain_fns.items()}
    plain["amp_pairs"] = time_fn(lambda: fp.amp_pairs_plain(vis_t), warmup=1, iters=3)
    plain["amp_pairs channel-major"] = time_fn(
        lambda: fp.amp_pairs_plain(vis, channel_major=True), warmup=1, iters=3)
    best = min(fp.CLUSTERS, key=lambda g: dein_ms[f"K12 g{g}"][0])
    inplace = min(fp.CLUSTERS, key=lambda g: dein_ms[f"channel_major g{g}"][0])
    kernel = {**stage_ms, **{v: rank_ms[v] for v in fp.RANK_SEARCHES},
              **{v: roll_ms[v] for v in fp.MEDIANS},
              f"channel_major, clusters of {inplace}": dein_ms[f"channel_major g{inplace}"][0],
              "amp_pairs": dein_ms["K12 baseline-major"][0],
              "amp_pairs channel-major": dein_ms[f"K12 g{best}"][0]}
    print(f"kernel vs plain on the whole dump (plain: 1 warm-up, median of 3) on {card}:")
    for v, ms in kernel.items():
        p = plain.get(v, plain["full"])  # the other bit-exact variants' plain version is K1's
        print(f"  {v}: {ms:.3f} ms vs plain {p:.3f} ms [{card}]")
    print(f"  stage costs (full less the stand-in): "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in stages.items())
          + f"; skeleton {stage_ms['skeleton']:.3f} ms against the 0.71 ms traffic floor [{card}]")
    for v in fp.RANK_SEARCHES:
        print(f"  {v} - full: {rank_ms[v] - rank_ms['binary']:+.3f} ms [{card}]")
    for v in fp.MEDIANS:
        print(f"  {v} - full: {roll_ms[v] - roll_ms['full']:+.3f} ms [{card}]")
    # K13's and K9's records are their fastest variants, named.
    fastest = min(fp.RANK_SEARCHES, key=rank_ms.get)
    fastest_median = min(fp.MEDIANS, key=roll_ms.get)
    # `full`, the K13 and the K9 variants do K1's work; K12 reads 8 B and
    # writes 4 B per visibility and does the amplitude's 4 operations.
    n_vis = rows * channels
    k1_work = (9 * n_vis, inventory_ops() * n_vis)
    return {
        "stage_ablate": record(counts["stage_ablate"], stage_ms["full"], plain["full"], *k1_work),
        "rankpair": dict(record(counts["rankpair"], rank_ms[fastest],
                                plain.get(fastest, plain["full"]), *k1_work), variant=fastest),
        "rollchain": dict(record(counts["rollchain"], roll_ms[fastest_median], plain["full"],
                                 *k1_work), variant=fastest_median),
        "deinterleave": dict(record(counts["deinterleave"], dein_ms[f"K12 g{best}"][0],
                                    plain["amp_pairs channel-major"], 12 * n_vis, 4 * n_vis,
                                    k12_library), variant=f"clusters of {best} rows"),
    }


def phase_examples(card: str, check: Check) -> dict:
    from katsdpsigproc_tpu_torch.examples import (fill_reduce, hello_device, triple, triple_fn,
                                                  triple_op, triple_pallas)
    from katsdpsigproc_tpu_torch.scripts.common import report
    from katsdpsigproc_tpu_torch.utils.profiling import time_interleaved

    dev = torch.device("cuda", 0)
    print("the tutorial kernels K6 (Triton) and K7 (CUDA C++) against x * 3 and data * scale:")
    rs = np.random.RandomState(9)
    for n in (4 * triple_pallas.BLOCK, 1000):
        x = torch.from_numpy(rs.uniform(size=n).astype(np.float32)).to(dev)
        check.exact("triple", f"K6 n={n}", triple_pallas.triple(x), triple_pallas.triple_plain(x))
    for shape in ((8, 128), (3, 333)):
        x = torch.from_numpy(rs.uniform(size=shape).astype(np.float32)).to(dev)
        check.exact("multiply", f"K7 {shape}", triple.multiply(x, 3.0),
                    triple.multiply_plain(x, 3.0))
    # The tiles' edges: K6's program of TILE elements; K7's CTA of 1024
    # threads, one float4 each, also from an odd address.
    def edges(tile):
        return (tile - 1, tile, tile + 1, 3 * tile + 5)

    for n in edges(triple_pallas.TILE):
        x = torch.from_numpy(rs.uniform(size=n).astype(np.float32)).to(dev)
        check.exact("triple", f"K6 n={n}", triple_pallas.triple(x), triple_pallas.triple_plain(x))
    for n in edges(1024 * 4):
        base = torch.from_numpy(rs.uniform(size=n + 1).astype(np.float32)).to(dev)
        for offset in (0, 1):
            x = base[offset:offset + n]
            check.exact("multiply", f"K7 n={n} offset {offset}", triple.multiply(x, 0.1),
                        triple.multiply_plain(x, 0.1))
    n = 1 << 28  # 1 GiB of float32 each way
    gen = torch.Generator(device=dev).manual_seed(1)
    big = torch.empty(n, device=dev).uniform_(-1.0, 1.0, generator=gen)
    square = big.view(1 << 14, 1 << 14)
    check.exact("triple", "K6 n=2**28", triple_pallas.triple(big), triple_pallas.triple_plain(big))
    check.exact("multiply", "K7 2**14 x 2**14", triple.multiply(square, 0.1),
                triple.multiply_plain(square, 0.1))
    check.exact("multiply", "K7 2**28 - 1 from an odd address (no 16-byte vectors)",
                triple.multiply(big[1:], 0.1), triple.multiply_plain(big[1:], 0.1))

    # The examples' entry point, with the launch counts set to 0 just before
    # and read just after.
    print("the examples on the card:")
    triple.launches["multiply"] = 0
    triple_pallas.launches["triple"] = 0
    for example in (hello_device, triple_fn, triple, triple_pallas, triple_op, fill_reduce):
        print(f"  python -m {example.__name__}:")
        example.main([])
    torch.cuda.synchronize()
    launches = {"multiply": triple.launches["multiply"], "triple": triple_pallas.launches["triple"]}
    print(f"  launches during the examples: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched by the examples")

    # K7 and K6 against their plain versions and PyTorch's calls, at 2**28,
    # host-paced as every other kernel here is timed.
    fns = {"k7": lambda: triple.multiply(big, 0.1),
           "k7 plain": lambda: triple.multiply_plain(big, 0.1),
           "data * scale": lambda: big * 0.1,
           "k6": lambda: triple_pallas.triple(big),
           "k6 plain": lambda: triple_pallas.triple_plain(big),
           "x * 3": lambda: big * 3}
    nbytes = 2 * n * 4
    print(f"K7 and K6 at n = {n} float32 ({nbytes / 1e9:.2f} GB moved a call), 5 interleaved "
          f"rounds of 3 calls, on {card}:")
    med, samples = time_interleaved(fns, reps=5, iters=3)
    for name in fns:
        report(name, med[name], samples[name], card)
    return {
        "triple": record(launches["triple"], med["k6"], med["k6 plain"], nbytes, n,
                         med["x * 3"]),
        "multiply": record(launches["multiply"], med["k7"], med["k7 plain"], nbytes, n,
                           med["data * scale"]),
    }


def instruction_rate(prim_cost, dev, card: str, block_ms: float, steps: int = 512,
                     unroll: int = 16) -> float:
    """The float32 instruction rate the card reaches, behind every operation bound.

    K8's add chain at K1's launch (``fminf`` and ``__fadd_rn``, two
    instructions a rep) on its default block of 264 rows of 32768, two
    whole waves of one CTA per SM, device-paced in `block_ms`: the rate the
    bounds are held to, so that they do not move silently.
    """
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = prim_cost.launch_config("add")
    rows = prim_cost.K1_ROWS
    rate = rows * prim_cost.K1_CHANNELS * 2 * steps * unroll / (block_ms / 1e3)
    waves = rows / (sms * cfg["ctas_per_sm"])
    print(f"float32 instruction rate: K8 add chain at K1's launch on ({rows}, "
          f"{prim_cost.K1_CHANNELS}), {waves:g} waves of {cfg['ctas_per_sm']} CTA per SM on "
          f"{sms} SMs, device-paced: {block_ms:.4f} ms, {rate:.4e} instructions/s against the "
          f"bounds' {F32_OPS_PER_S:.4e} ({rate / F32_OPS_PER_S:.3f}) [{card}]")
    card_state("after the instruction-rate chain")
    return rate


def phase_cost_probes(ff, device, vis_np: np.ndarray, card: str, check: Check) -> dict:
    from katsdpsigproc_tpu_torch.models.rfi import flagger_probe as fp
    from katsdpsigproc_tpu_torch.scripts import prim_cost, roofline_skeleton as rsk
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn, time_queued

    dev = torch.device("cuda", 0)
    channels, rows = vis_np.shape
    # K8 at K1's launch on a full wave of 32768-channel rows, a row count
    # that is not a multiple of the SMs', and a narrower row whose last warp
    # is partly without a run.
    print("K8 (csrc/prim_cost.cu) against its plain chains, 2 steps x 4 reps:")
    for shape in ((132, 32768), (137, 32768), (7, 4160)):
        x = prim_cost.block(*shape, dev)
        for body in [None] + list(prim_cost.ALL_BODIES):
            got = prim_cost.chain(x, body, 2, 4)
            want = prim_cost.chain_plain(x, body, 2, 4)
            label = f"K8 {shape[0]}x{shape[1]} {body or 'empty'}"
            if body == "reduce":  # the kernel sums a row in another order
                check.close("prim_cost", label, got, want, rtol=1e-6)
            else:
                check.exact("prim_cost", label, got, want)
    del x, got, want
    # K8 and K10 exactly as K1 launches.
    k1_cfg = ff.launch_config(channels)
    for body in [None] + list(prim_cost.ALL_BODIES):
        cfg = prim_cost.launch_config(body)
        if cfg != k1_cfg:
            raise AssertionError(f"K8 {body} does not launch as K1 does ({k1_cfg}): {cfg}")
    print(f"  launch K8 at K1's launch, every body: {cfg} (K1: {k1_cfg})")
    cfg = rsk.launch_config(channels)
    print(f"  launch K10: {cfg['threads']} threads, {cfg['smem_bytes']} B dynamic shared memory, "
          f"{cfg['ctas_per_sm']} CTA per SM (K1: {k1_cfg})")
    if cfg != k1_cfg:
        raise AssertionError(f"K10 does not launch as K1 does ({k1_cfg}): {cfg}")

    print("K10 (csrc/roofline_skeleton.cu) against its plain version, output and rank carry:")
    vis = torch.from_numpy(device.to_planar(vis_np)).to(dev)  # (C, rows, 2)
    amp = fp.amp_pairs(vis, channel_major=True)  # (rows, C), the dump's amplitudes
    vis_t = vis.transpose(0, 1).contiguous()  # for K11's full beside the skeleton
    del vis
    rs = np.random.RandomState(11)
    cases = [(f"uniform {r}x{c}", torch.from_numpy(
        rs.uniform(0.25, 0.75, (r, c)).astype(np.float32)).to(dev)) for r, c in ((128, 257),
                                                                             (8, 32768))]
    cases.append(("dump amplitudes, 512 rows", amp[:512]))
    for label, x in cases:
        for scale in (rsk.FLAG_SCALE, 1.0):
            out, rank = rsk.skeleton(x, flag_scale=scale, return_rank=True)
            want_out, want_rank = rsk.skeleton_plain(x, flag_scale=scale, return_rank=True)
            check.flags("roofline_skeleton", f"K10 {label}, scale {scale}: output", out, want_out)
            check.exact("roofline_skeleton", f"K10 {label}, scale {scale}: rank carry", rank,
                        want_rank)

    def plain_whole(**kw):
        def run():
            out = torch.empty((rows, channels), dtype=torch.uint8, device=dev)
            rank = torch.empty((rows,), dtype=torch.float32, device=dev)
            for s in range(0, rows, 2016):
                out[s:s + 2016], rank[s:s + 2016] = rsk.skeleton_plain(amp[s:s + 2016],
                                                                      return_rank=True, **kw)
            return out, rank
        return run

    out, rank = rsk.skeleton(amp, return_rank=True)
    want_out, want_rank = plain_whole()()
    check.flags("roofline_skeleton", "K10 whole dump: output", out, want_out)
    check.exact("roofline_skeleton", "K10 whole dump: rank carry", rank, want_rank)
    if out.any():
        raise AssertionError("the skeleton's output is not 0")
    del out, rank, want_out, want_rank

    # The cost-probe path: K8's table, then K10 and K11 on the whole dump
    # beside the model priced two ways, with the launch counts set to 0 just
    # before and read just after.
    print(f"the cost-probe tools (prim_cost on {prim_cost.K1_ROWS} x {prim_cost.K1_CHANNELS}, "
          f"512 steps x 16 reps; the skeleton and K11 on the whole dump) on {card}:")
    prim_cost.reset_launches()
    rsk.launches["skeleton"] = 0
    result = rsk.run(vis_t, iters=3, reps=5, card=card)
    del vis_t
    torch.cuda.synchronize()
    card_state("after the cost-probe tools")
    launches = {"prim_cost": sum(prim_cost.launches.values()),
                "roofline_skeleton": rsk.launches["skeleton"]}
    print(f"  launches during the cost-probe path: {launches} "
          f"(per body: {dict(prim_cost.launches)})")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the cost-probe path")

    # The record: K8's add chain at K1's launch on its block.
    steps, unroll = 512, 16
    k1_block = prim_cost.default_block(dev)
    med = time_queued({"k1": lambda: prim_cost.chain(k1_block, "add", steps, unroll)},
                      reps=5, iters=3)[0]
    add_plain = time_fn(lambda: prim_cost.chain_plain(k1_block, "add", steps, unroll), warmup=1,
                        iters=2)
    skel_plain = time_fn(plain_whole(), warmup=1, iters=2)
    elems = k1_block.numel()
    k1_rate = elems * 2 * steps * unroll / (med["k1"] / 1e3)
    print(f"kernel vs plain on {card}: K8 add chain at K1's launch ({prim_cost.K1_ROWS} x "
          f"{prim_cost.K1_CHANNELS}) {med['k1']:.3f} ms vs {add_plain:.3f} ms, "
          f"{k1_rate:.4e} instructions/s ({k1_rate / F32_OPS_PER_S:.3f} of the bounds' rate); "
          f"K10 whole dump "
          f"{result['skeleton_ms']:.3f} ms vs {skel_plain:.3f} ms; K10 / K11 full "
          f"{result['skeleton_ms'] / result['full_ms']:.3f} in the same rounds")
    instruction_rate(prim_cost, dev, card, med["k1"], steps, unroll)
    n_vis = rows * channels
    return {
        # The chain reads and writes the block once; y0, 2 operations a rep, x + y.
        "prim_cost": record(launches["prim_cost"], med["k1"], add_plain, 2 * elems * 4,
                            elems * (2 + 2 * steps * unroll + 1)),
        # 4 B of amplitude in and 1 B out per visibility; the inventory's work.
        "roofline_skeleton": record(launches["roofline_skeleton"], result["skeleton_ms"],
                                    skel_plain, 5 * n_vis, inventory_ops() * n_vis),
    }


def mask_check(label: str, got: np.ndarray, want: np.ndarray) -> None:
    """Flag-for-flag equality of two numpy masks."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} vs {want.shape}")
    bad = int((got != want).sum())
    print(f"  {label}: {bad} mismatching flags of {got.size} ({int(want.sum())} flagged)")
    if bad:
        raise AssertionError(f"{label}: {bad} mismatching flags")


def rowwise_error(label: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    """Each row's relative error ||got - want|| / ||want|| within `rtol`.

    An FFT's float32 error grows with its length and its row's norm, so
    ``tests/test_fft.py``'s element-wise atol (set for 35- and 48-point
    transforms) does not hold at 32768 points between two float32
    libraries; its rtol is held here row by row, and the element-wise
    figures are printed.
    """
    got, want = got.cpu().to(torch.complex128), want.cpu().to(torch.complex128)
    diff = (got - want).abs()
    rel = torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)
    worst = float(rel.max())
    beyond = int((diff > 1e-3 + rtol * want.abs()).sum())
    print(f"  {label}: largest row relative error {worst:.3g} (rtol {rtol}); element-wise max "
          f"|err| {float(diff.max()):.3g}, {beyond} of {want.numel()} beyond atol 1e-3 + rtol")
    if not worst <= rtol:
        raise AssertionError(f"{label}: a row's relative error {worst:.3g} exceeds {rtol}")


def box_filter_work(shape, sigma, passes: int = 4) -> tuple:
    """The bytes and ordered adds of one masked Gaussian filter of (B, T, F) `shape`.

    Bytes: the data (4 B) and flags (1 B) read, the two planes written and
    read back between the axes (16 B), the quotient written (4 B).  Adds:
    2r an output of each pass, on the outputs the crop can reach (pass k
    of the line's n + 2 (passes - k) r), for both planes.
    """
    from katsdpsigproc_tpu_torch.models.rfi import twodflag

    steps = twodflag.box_filter_plan(shape, sigma, passes)
    n = int(np.prod(shape))
    nbytes = n * (5 + 16 * (len(steps) - 1) + 4)
    adds = 0
    for step in steps:
        line, r = shape[step.axis], step.radius
        outputs = sum(line + 2 * (passes - k) * r for k in range(1, passes + 1)) if r else 0
        adds += 2 * (n // line) * 2 * r * outputs
    return nbytes, adds


def box_filter_calls(flagger) -> tuple:
    """The masked Gaussian filters of one batch of `flagger`, and their kernel launches.

    The spectrum's background, then the 2-D background: each filters at
    every extend factor from ``background_iterations`` down to 1, then
    once more at 1.
    """
    from katsdpsigproc_tpu_torch.models.rfi import twodflag

    calls = launches = 0
    for width_time in (0.0, flagger.spike_width_time):
        for factor in list(range(flagger.background_iterations, 0, -1)) + [1]:
            sigma = (0.0, factor * width_time, factor * flagger.spike_width_freq)
            calls += 1
            launches += len(twodflag.box_filter_plan((1, 1, 1), sigma))
    return calls, launches


def phase_box_filter(twodflag, dev, card: str, check: Check) -> tuple:
    """The box-filter kernels at a calibrator scan's batch shapes, against their
    plain version on the same card tensors, and timed.  Returns the batch call's
    ms, its plain version's ms, bytes and adds."""
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    n_bl, n_time, n_freq = BASELINES, 75, 1024
    rs = np.random.RandomState(seed=2)
    amp = np.abs(rs.standard_normal((n_time, n_freq, n_bl))).astype(np.float32)
    flags = rs.random_sample(amp.shape) < 0.05
    amp.reshape(-1)[rs.choice(amp.size, 8)] = np.nan  # unflagged NaN and inf
    amp.reshape(-1)[rs.choice(amp.size, 8)] = np.inf
    # 80 channels all flagged: NaN at their middle, which no weight reaches (4 passes of r 8)
    flags[:, 400:480] = True
    # (B, T, F) views of (T, F, B) cubes: baselines innermost, as the flagger's averaged data
    data = torch.from_numpy(amp).to(dev).permute(2, 0, 1)
    flags = torch.from_numpy(flags).to(dev).permute(2, 0, 1)
    spectrum, spectrum_flags = data[:, :1].contiguous(), flags[:, :1].contiguous()
    cases = {
        f"batch {n_bl} x {n_time} x {n_freq}, baselines innermost, sigma (0, 12.5, 10)":
            (data, flags, np.array((0.0, 12.5, 10.0))),
        f"spectrum ({n_bl}, 1, {n_freq}), sigma (0, 0, 10)":
            (spectrum, spectrum_flags, np.array((0.0, 0.0, 10.0))),
    }
    times = {}
    for label, (d, f, sigma) in cases.items():
        print(f"the masked Gaussian filter, {label}:")
        before = dict(twodflag.launches)
        got = twodflag.masked_gaussian_filter(d, f, sigma)
        torch.cuda.synchronize()
        ran = {k: twodflag.launches[k] - before[k] for k in before}
        want_launches = len(twodflag.box_filter_plan(d.shape, sigma))
        print(f"  launches {ran}")
        if sum(ran.values()) != want_launches:
            raise AssertionError(f"{label}: {ran} launches, the plan gives {want_launches}")
        want = twodflag.masked_gaussian_filter_plain(d, f, sigma)
        check.exact("box_filter", f"{label}: kernels vs plain version on the card", got, want)
        if not (bool(torch.isnan(got).any()) and bool(torch.isfinite(got).any())):
            raise AssertionError(f"{label}: no NaN or no finite value to compare")
        del got, want
        card_state(f"before the masked Gaussian filter's timings, {label}")
        ms = time_fn(lambda: twodflag.masked_gaussian_filter(d, f, sigma), warmup=1, iters=5)
        plain_ms = time_fn(lambda: twodflag.masked_gaussian_filter_plain(d, f, sigma),
                           warmup=1, iters=3)
        nbytes, adds = box_filter_work(tuple(d.shape), sigma)
        bound = max(nbytes / HBM_BYTES_PER_S, adds / F32_OPS_PER_S) * 1e3
        print(f"  kernels {ms:.3f} ms (CUDA events, 1 warm-up, median of 5), plain version "
              f"{plain_ms:.3f} ms (median of 3); bound {bound:.3f} ms ({nbytes / 1e9:.2f} GB, "
              f"{adds / 1e9:.2f} G ordered adds) [{card}]")
        times[label] = (ms, plain_ms, nbytes, adds)
    del data, flags, spectrum, spectrum_flags
    torch.cuda.empty_cache()
    return next(iter(times.values()))


def sum_threshold_ops(windows) -> int:
    """The SumThreshold chain's float32 operations a sample: per window of w, the
    two clamping compares, w - 1 ordered adds, two products and two compares."""
    return sum(w - 1 + 6 for w in windows)


def phase_sum_threshold(twodflag, dev, card: str, check: Check) -> dict:
    """The SumThreshold kernel's three calls of a calibrator scan's batch (its
    spectrum, both axes) against its plain version on the same card tensors, and
    timed; its spill report.  Returns its ``kernels``-line record: the three calls
    together."""
    from katsdpsigproc_tpu_torch.utils import kernels
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    twodflag._st_library()
    log = kernels.build_info[kernels.build_key("sum_threshold", ["sum_threshold.cu"], {})]["log"]
    report = ptxas_report(log)
    for name, r in report.items():
        print(f"  sum_threshold {name}: {r.get('registers')} registers, {r['stack']} B stack "
              f"frame, {r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    if not report or any(r["spill_stores"] or r["spill_loads"] for r in report.values()):
        raise AssertionError(f"the SumThreshold kernel spills or is missing from the report: "
                             f"{report}")
    n_bl, n_time, n_freq = BASELINES, 75, 1024
    windows, nsigma, rho = [1, 2, 4, 8], 4.5, 1.3
    g = torch.Generator(device=dev).manual_seed(3)
    # (B, T, F) views of (T, F, B) residuals: baselines innermost, as the flagger holds them
    data = torch.randn((n_time, n_freq, n_bl), device=dev, generator=g)
    spikes = torch.rand(data.shape, device=dev, generator=g) < 0.02
    data = torch.where(spikes, data * (torch.rand(data.shape, device=dev, generator=g) * 40 - 15),
                       data)
    flat = data.view(-1)
    picks = torch.randint(0, flat.numel(), (16,), device=dev, generator=g)
    flat[picks[:8]] = torch.nan  # unflagged NaN and inf
    flat[picks[8:]] = torch.inf
    flags = torch.rand(data.shape, device=dev, generator=g) < 0.05
    data, flags = data.permute(2, 0, 1), flags.permute(2, 0, 1)
    # the spectrum, (B, 1, F) contiguous, with its own unflagged NaN and inf
    spectrum, spectrum_flags = data[:, :1].contiguous(), flags[:, :1].contiguous()
    nan_at, inf_at = picks[:4] % spectrum.numel(), picks[8:12] % spectrum.numel()
    spectrum.view(-1)[nan_at] = torch.nan
    spectrum.view(-1)[inf_at] = torch.inf
    spectrum_flags.view(-1)[torch.cat((nan_at, inf_at))] = False
    axes = {}
    for label, lines, line_flags, n_chunks in (
            (f"time lines of {n_bl} x {n_time} x {n_freq}", data, flags, 1),
            ("frequency lines, 8 chunks", data.transpose(1, 2), flags.transpose(1, 2), 8),
            (f"spectrum ({n_bl}, 1, {n_freq}) contiguous, 8 chunks", spectrum.transpose(1, 2),
             spectrum_flags.transpose(1, 2), 8)):
        chunks = np.linspace(0, lines.shape[1], n_chunks + 1).astype(np.int_)
        threshold = twodflag._chunk_thresholds(lines, line_flags, nsigma, chunks)
        before = twodflag.launches["sum_threshold"]
        got = twodflag.sum_threshold_cuda(lines, threshold, windows, rho, chunks)
        torch.cuda.synchronize()
        ran = twodflag.launches["sum_threshold"] - before
        print(f"SumThreshold, {label}, windows {windows}: {ran} launch")
        if ran != 1:
            raise AssertionError(f"{label}: {ran} launches, want 1")
        want = twodflag.sum_threshold_plain(lines, threshold, windows, rho, chunks)
        check.flags("sum_threshold", f"{label}: kernel vs plain version on the card", got, want)
        del got, want
        axes[label] = (lines, threshold, chunks)
    card_state("before the SumThreshold kernel's timings")

    def calls(fn):
        return lambda: [fn(lines, threshold, windows, rho, chunks)
                        for lines, threshold, chunks in axes.values()]

    ms = time_fn(calls(twodflag.sum_threshold_cuda), warmup=1, iters=10)
    plain_ms = time_fn(calls(twodflag.sum_threshold_plain), warmup=1, iters=3)
    samples = 2 * data.numel() + spectrum.numel()
    nbytes = samples * (4 + 1)  # each call: the data read, the flags written
    ops = samples * sum_threshold_ops(windows)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    print(f"  the batch's 3 calls: kernel {ms:.3f} ms (3 launches; CUDA events, 1 warm-up, "
          f"median of 10), plain version {plain_ms:.3f} ms (median of 3); bound {bound:.3f} ms "
          f"({nbytes / 1e9:.2f} GB, {ops / 1e9:.2f} G operations) [{card}]")
    del data, flags, spikes, spectrum, spectrum_flags, axes
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "nbytes": nbytes, "ops": ops}


def phase_masked_median(twodflag, dev, card: str, check: Check) -> dict:
    """The median kernel on a calibrator scan's batch: the flagger's six calls (its
    populations in the layouts it holds them in, 8 chunks in frequency) against the
    plain version on the same card tensors, then timed beside their bound and the
    plain version (a sort a chunk: the batch's 34 sorts).  Returns its ``kernels``-line
    record: the six calls together."""
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    n_bl, n_time, n_freq = BASELINES, 75, 1024
    chunks = np.linspace(0, n_freq, 9).astype(np.int_)
    whole = np.array([0, n_time])
    g = torch.Generator(device=dev).manual_seed(4)
    cube = (n_time, n_freq, n_bl)
    # (B, T, F) views of (T, F, B) cubes: baselines innermost, as the flagger holds them
    amp = torch.randn(cube, device=dev, generator=g).abs_().permute(2, 0, 1)
    residual = torch.randn(cube, device=dev, generator=g).permute(2, 0, 1)
    flags = (torch.rand(cube, device=dev, generator=g) < 0.05).permute(2, 0, 1)
    flags[:, :, 400:480] = True  # channels all flagged: the time median's empty value
    # the 2-D background's |residual| and flags in (B, T, F) order, and the spectrum's
    dense, dense_flags = residual.abs().contiguous(), flags.contiguous()
    spectrum, spectrum_flags = dense[:, :1].contiguous(), dense_flags[:, :1].contiguous()
    calls = {
        "time median": (amp, flags, whole, {"empty_value": 0.0}),
        "spectrum's background": (spectrum.transpose(1, 2), spectrum_flags.transpose(1, 2),
                                  chunks, {"empty_value": np.nan, "blocks": True}),
        "spectrum's thresholds": (spectrum.transpose(1, 2), spectrum_flags.transpose(1, 2),
                                  chunks, {"empty_value": np.nan, "take_abs": True}),
        "2-D background": (dense.transpose(1, 2), dense_flags.transpose(1, 2), chunks,
                           {"empty_value": np.nan, "blocks": True}),
        "time thresholds": (residual, flags, whole, {"empty_value": np.nan, "take_abs": True}),
        "frequency thresholds": (residual.transpose(1, 2), flags.transpose(1, 2), chunks,
                                 {"empty_value": np.nan, "take_abs": True}),
    }
    print(f"the masked medians of a batch, {n_bl} x {n_time} x {n_freq}:")
    nbytes = 0
    for label, (d, f, c, kw) in calls.items():
        before = twodflag.launches["median"]
        got = twodflag.masked_median(d, f, c, **kw)
        torch.cuda.synchronize()
        ran = twodflag.launches["median"] - before
        if ran != 1:
            raise AssertionError(f"{label}: {ran} launches, want 1")
        want = twodflag.masked_median_plain(d, f, c, **kw)
        check.exact("masked_median", f"{label}: kernel vs plain version on the card", got, want)
        if not bool(torch.isfinite(got).any()):
            raise AssertionError(f"{label}: no finite median to compare")
        del got, want
        nbytes += d.numel() * (4 + 1) + 4 * (len(c) - 1) * d.shape[0] * (
            1 if kw.get("blocks") else d.shape[2])  # data and flags read, medians written
    card_state("before the median kernel's timings")
    for label, (d, f, c, kw) in calls.items():
        ms = time_fn(lambda: twodflag.masked_median(d, f, c, **kw), warmup=1, iters=10)
        print(f"  {label}: kernel {ms:.3f} ms ({d.numel() * 5 / HBM_BYTES_PER_S * 1e3:.3f} ms "
              f"of bytes)")

    def batch(fn):
        return lambda: [fn(d, f, c, **kw) for d, f, c, kw in calls.values()]

    ms = time_fn(batch(twodflag.masked_median), warmup=1, iters=10)
    plain_ms = time_fn(batch(twodflag.masked_median_plain), warmup=1, iters=3)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  the batch's 6 calls: kernel {ms:.3f} ms (6 launches; CUDA events, 1 warm-up, "
          f"median of 10), plain version {plain_ms:.3f} ms (34 sorts; median of 3); bound "
          f"{bound:.3f} ms ({nbytes / 1e9:.2f} GB) [{card}]")
    del amp, residual, flags, dense, dense_flags, spectrum, spectrum_flags, calls
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "nbytes": nbytes}


def phase_twod_fft(ff, device, vis_np: np.ndarray, card: str, check: Check) -> dict:
    """The box-filter kernels, the 2-D flagger (configs 1 and rfiflagtest's 16
    baselines), the FFT path (config 4) and FusedFlaggerTemplate on the card."""
    from katsdpsigproc_tpu_torch import MAD_NORMAL
    from katsdpsigproc_tpu_torch.models.rfi import twodflag
    from katsdpsigproc_tpu_torch.ops import fft, rank
    from katsdpsigproc_tpu_torch.scripts import fftflagtest, rfiflagtest
    from katsdpsigproc_tpu_torch.utils import backend, numerics, tune
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    dev = torch.device("cuda", 0)
    box_ms, box_plain_ms, box_bytes, box_adds = phase_box_filter(twodflag, dev, card, check)
    st = phase_sum_threshold(twodflag, dev, card, check)
    mm = phase_masked_median(twodflag, dev, card, check)
    oracle = rfiflagtest.load_twodflag_oracle()
    times, channels = 3000, 1024
    rs = np.random.RandomState(seed=1)  # bench.py config 1
    shape = (times, channels, 1)
    config1 = np.abs(rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.float32)
    spiked = np.abs(rfiflagtest.generate_data(times, channels, 16))
    flagger = twodflag.SumThresholdFlagger()
    calls_per_batch, launches_per_batch = box_filter_calls(flagger)
    box_launches = st_launches = mm_launches = 0
    for label, amp in (("config 1, 3000 x 1024 x 1 (seed 1)", config1),
                       ("rfiflagtest's spiked data, 3000 x 1024 x 16 (one chunk)", spiked)):
        print(f"the 2-D flagger (SumThresholdFlagger()), {label}:")
        zeros = np.zeros(amp.shape, bool)
        for counts in (twodflag.box_filters, twodflag.sum_thresholds, twodflag.medians,
                       twodflag.launches):
            counts.update(dict.fromkeys(counts, 0))
        n_batches = twodflag.batches["batches"]
        t0 = time.perf_counter()
        on_card = flagger.get_flags(amp, zeros)
        t1 = time.perf_counter()
        n_batches = twodflag.batches["batches"] - n_batches
        filters, launched = dict(twodflag.box_filters), dict(twodflag.launches)
        chains, medians = dict(twodflag.sum_thresholds), dict(twodflag.medians)
        st_launched, mm_launched = launched.pop("sum_threshold"), launched.pop("median")
        print(f"  {n_batches} batch(es): masked Gaussian filters by route {filters}, "
              f"box-filter launches {launched}; SumThreshold chains by route {chains}, "
              f"{st_launched} launches; medians by route {medians}, {mm_launched} launches")
        if filters != {"kernel": calls_per_batch * n_batches, "plain": 0}:
            raise AssertionError(f"{label}: filters {filters}, want {calls_per_batch} a batch, "
                                 f"all on the kernels")
        if sum(launched.values()) != launches_per_batch * n_batches:
            raise AssertionError(f"{label}: {launched} box-filter launches, want "
                                 f"{launches_per_batch} a batch")
        # the spectrum's, time's and frequency's chains: 3 launches a batch
        if chains != {"kernel": 3 * n_batches, "plain": 0} or st_launched != 3 * n_batches:
            raise AssertionError(f"{label}: SumThreshold chains {chains} and {st_launched} "
                                 f"launches, want 3 a batch, all on the kernel")
        # the time median, the spectrum's background and thresholds, the 2-D
        # background, the time and the frequency thresholds: 6 a batch
        if medians != {"kernel": 6 * n_batches, "plain": 0} or mm_launched != 6 * n_batches:
            raise AssertionError(f"{label}: medians {medians} and {mm_launched} launches, want "
                                 f"6 a batch, all on the kernel")
        box_launches += sum(launched.values())
        st_launches += st_launched
        mm_launches += mm_launched
        on_cpu = flagger.get_flags(amp, zeros, device="cpu")
        t2 = time.perf_counter()
        expected = oracle.get_flags(amp[..., :1], zeros[..., :1])
        t3 = time.perf_counter()
        print(f"  first call on the card {t1 - t0:.1f} s, the port on the CPU {t2 - t1:.1f} s, "
              f"the numpy oracle on 1 baseline {t3 - t2:.1f} s")
        mask_check("card vs the port on the CPU", on_card, on_cpu)
        mask_check("card vs the numpy oracle, baseline 0", on_card[..., :1], expected)
        impl = flagger._impl(amp.shape)
        data, flags = torch.from_numpy(amp).to(dev), torch.zeros(amp.shape, dtype=torch.bool,
                                                                  device=dev)
        card_state("before the 2-D flagger's timings")
        ms = time_fn(lambda: impl(data, flags), warmup=1, iters=5)
        host_ms = time_fn(lambda: flagger.get_flags(amp, zeros), warmup=1, iters=5)
        n_vis = amp.size
        print(f"  on the card: {ms:.3f} ms ({n_vis / ms / 1e3:.3f} Mvis/s), the flagger on tensors "
              f"on the card (CUDA events, 1 warm-up, median of 5); get_flags from and to the "
              f"host {host_ms:.3f} ms ({n_vis / host_ms / 1e3:.3f} Mvis/s); flagged fraction "
              f"{on_card.mean():.5f} [{card}]")
        del data, flags

    b, c, nsigma = 256, 32768, 5.0
    print(f"the FFT path (fftflagtest) at config 4, {b} x {c} float32:")
    data = fftflagtest.make_data(b, c)
    cpu, gpu = backend.DeviceContext(torch.device("cpu")), backend.DeviceContext(dev)
    x_cpu, x_gpu = torch.from_numpy(data), torch.from_numpy(data).to(dev)
    r2c, c2r = {}, {}
    for where, ctx in (("cpu", cpu), ("card", gpu)):
        r2c[where] = fft.FftTemplate(ctx, 1, (b, c), np.float32, np.complex64).instantiate(
            None, fft.FftMode.FORWARD)
        c2r[where] = fft.FftTemplate(ctx, 1, (b, c), np.complex64, np.float32).instantiate(
            None, fft.FftMode.INVERSE)
    spectrum = r2c["cpu"](src=x_cpu)["dest"]
    rowwise_error("Fft r2c, card vs CPU", r2c["card"](src=x_gpu)["dest"], spectrum, 1e-4)
    rowwise_error("Fft c2r (unnormalised), card vs CPU", c2r["card"](src=spectrum.to(dev))["dest"],
                  c2r["cpu"](src=spectrum)["dest"], 1e-3)
    flag_cpu, _ = fftflagtest.make_spectral_flag(cpu, b, c, nsigma)(x_cpu)
    spectral_flag = fftflagtest.make_spectral_flag(gpu, b, c, nsigma)
    flag_gpu, cleaned = spectral_flag(x_gpu)
    amp = numerics.complex_abs(spectrum)
    threshold = float(np.float32(nsigma)) * (float(np.float32(MAD_NORMAL))
                                             * rank.median_non_zero(amp))[:, None]
    near = ((amp - threshold).abs() <= fftflagtest.NEAR * threshold).numpy()
    differ = (flag_gpu.cpu() != flag_cpu).numpy()
    bad = int(differ[~near].sum())
    print(f"  flags, card vs CPU: {bad} mismatching of {differ.size} away from the threshold; "
          f"{int(near.sum())} bins within {fftflagtest.NEAR:g} of it (relative), {int(differ[near].sum())} of "
          f"them differ; {int(flag_cpu.sum())} flagged")
    if bad:
        raise AssertionError(f"FFT path: {bad} flags differ from the CPU run")
    if not (flag_gpu[0].sum() > 0 and flag_gpu[1].sum() < flag_gpu[0].sum()):
        raise AssertionError("FFT path: the planted sinusoid is not flagged as fftflagtest asserts")
    if not bool(torch.isfinite(cleaned).all()):
        raise AssertionError("FFT path: the cleaned series is not finite")
    card_state("before the FFT path's timings")
    ms = time_fn(lambda: spectral_flag(x_gpu), warmup=1, iters=5)
    spectrum_gpu = r2c["card"](src=x_gpu)["dest"]
    r2c_ms = time_fn(lambda: r2c["card"](src=x_gpu), warmup=1, iters=5)
    c2r_ms = time_fn(lambda: c2r["card"](src=spectrum_gpu), warmup=1, iters=5)
    print(f"  on the card: {ms:.3f} ms ({b * c / ms / 1e6:.3f} Gsamples/s), r2c {r2c_ms:.3f} ms, "
          f"c2r {c2r_ms:.3f} ms (CUDA events, 1 warm-up, median of 5) [{card}]")
    del x_gpu, spectrum_gpu, cleaned

    print("FusedFlaggerTemplate on the seed-1 dump:")
    ctx = backend.create_some_context()
    saved = tune.autotuner_impl
    tune.autotuner_impl = tune.force_autotuner
    try:
        pick = ff.FusedFlaggerTemplate(ctx).tuning
    finally:
        tune.autotuner_impl = saved
    print(f"  forced search pick on {ctx.device_kind}: {pick}")
    search = tune.autotune

    def no_search(*args, **kwargs):
        raise AssertionError("FusedFlaggerTemplate searched instead of reading the shipped table")

    tune.autotune = no_search
    try:
        tmpl = ff.FusedFlaggerTemplate(ctx)
    finally:
        tune.autotune = search
    if tmpl.tuning != pick:
        raise AssertionError(f"shipped record {tmpl.tuning} is not the forced pick {pick}")
    vis_t = torch.from_numpy(device.to_planar(vis_np)).to(dev).transpose(0, 1).contiguous()
    got, want = tmpl(vis_t), ff.flag_transposed(vis_t)
    bad = int((got != want).sum())
    print(f"  FusedFlaggerTemplate vs flag_transposed: {bad} mismatching flags of {got.numel()} "
          f"({int(want.count_nonzero())} flagged)")
    if bad:
        raise AssertionError(f"FusedFlaggerTemplate: {bad} flags differ from flag_transposed")
    # The calibrator-scan batch's calls; the launches, the flagger's counted runs'.
    return {"box_filter": record(box_launches, box_ms, box_plain_ms, box_bytes, box_adds),
            "sum_threshold": record(st_launches, st["ms"], st["plain_ms"], st["nbytes"],
                                    st["ops"]),
            "masked_median": record(mm_launches, mm["ms"], mm["plain_ms"], mm["nbytes"], 0)}


def phase_stream(ff, device, vis_np: np.ndarray, card: str, check: Check) -> None:
    from katsdpsigproc_tpu_torch.examples import resource_pipeline as rp
    from katsdpsigproc_tpu_torch.utils import backend

    channels, rows = vis_np.shape
    dumps = 5
    print(f"streaming ingest (examples/resource_pipeline, flagger 'fused') of {dumps} dumps of "
          f"{channels} x {rows}:")
    planar = device.to_planar(vis_np)
    t0 = time.perf_counter()
    host = torch.from_numpy(planar).pin_memory()  # once, outside the timed loop
    print(f"  pinned the {host.numel() * 4 / 1e9:.2f} GB host buffer in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in ff.launches:
        ff.launches[name] = 0
    results = rp.run(rp.SpikedDumps(host), dumps, "fused", backend.create_some_context(),
                     (channels, rows), card)
    torch.cuda.synchronize()
    print(f"  launches during the stream: {dict(ff.launches)}")
    if ff.launches["flagger"] < dumps:
        raise AssertionError("K1 was not launched for every streamed dump")
    del host
    base = torch.from_numpy(planar).cuda()
    for i in range(dumps):
        dump = base.clone()
        dump[rp.spike_channel(i)] *= 50.0  # as SpikedDumps plants it
        k1 = ff.flag_dump(dump.transpose(0, 1).contiguous())
        check.flags("flagger", f"streamed dump {i} vs flag_dump of the same dump",
                    torch.from_numpy(results[i]), k1.T.cpu())


def phase_parallel(ff, device, vis_np: np.ndarray, card: str, check: Check) -> None:
    """The port of ``parallel`` at world size 1 on an NCCL process group: K1
    through ``make_sharded_fused_flagger``, the stage flagger's collective rank
    search and halos, and ``get_flags_sharded``, each against its one-device
    counterpart, timed."""
    import torch.distributed as dist
    from katsdpsigproc_tpu_torch.models.rfi import twodflag
    from katsdpsigproc_tpu_torch.parallel import flagger as pflagger, mesh as pmesh, multihost
    from katsdpsigproc_tpu_torch.scripts.common import report
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn, time_interleaved

    t0 = time.perf_counter()
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        channels, rows = vis_np.shape
        print(f"parallel on an NCCL group of world size 1 ({multihost.process_summary()}), "
              f"the dump of {channels} x {rows}:")
        m1 = pmesh.make_mesh((1,), (pmesh.BASELINE_AXIS,))
        m11 = pmesh.make_mesh((1, 1), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))
        vis = torch.from_numpy(device.to_planar(vis_np)).cuda()  # (C, rows, 2), channel-major
        vis_t = vis.transpose(0, 1).contiguous()
        local_t = pmesh.shard_with_spec(m1, vis_t, (pmesh.BASELINE_AXIS,))
        local = pmesh.shard(m11, vis)
        fused = pflagger.make_sharded_fused_flagger(m1)
        staged = pflagger.make_sharded_flagger(m11, threshold="sum", baseline_block=1008)

        # The sharded path, with the launch counts set to 0 just before and read just after.
        for name in ff.launches:
            ff.launches[name] = 0
        fused_flags = fused(local_t)
        staged_flags = staged(local)
        torch.cuda.synchronize()
        print(f"  launches during the sharded path: {dict(ff.launches)}")
        if ff.launches["flagger"] < 1:
            raise AssertionError("K1 was not launched by make_sharded_fused_flagger")
        k1 = ff.flag_dump(vis_t)
        check.flags("flagger", "make_sharded_fused_flagger on a (1,) mesh vs flag_dump (K1)",
                    fused_flags, k1)
        check.flags("flagger", "make_sharded_flagger on a (1, 1) mesh, sum, baseline_block "
                    "1008, vs K1", staged_flags.T, k1)
        del fused_flags, staged_flags

        rs = np.random.RandomState(seed=1)  # bench.py config 1
        shape = (3000, 1024, 1)
        config1 = np.abs(rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(
            np.float32)
        zeros = np.zeros(shape, bool)
        flagger = twodflag.SumThresholdFlagger()
        print("get_flags_sharded on a (1,) mesh at config 1, 3000 x 1024 x 1 (seed 1):")
        mask_check("get_flags_sharded vs get_flags", flagger.get_flags_sharded(config1, zeros, m1),
                   flagger.get_flags(config1, zeros))

        print(f"timings on {card}:")
        card_state("before the sharded path's timings")
        medians, samples = time_interleaved(
            {"sharded_k1": lambda: fused(local_t), "flag_dump": lambda: ff.flag_dump(vis_t)},
            reps=5, iters=3)
        for name, ms in medians.items():
            report(name, ms, samples[name], card)
        staged_ms = time_fn(lambda: staged(local), warmup=1, iters=3)
        # Host-bound calls (thousands of launches each): compared in turns.
        medians_2d, samples_2d = time_interleaved(
            {"sharded_2d": lambda: flagger.get_flags_sharded(config1, zeros, m1),
             "single_2d": lambda: flagger.get_flags(config1, zeros)}, reps=7)
        for name, ms in medians_2d.items():
            report(name, ms, samples_2d[name], card)
        card_state("after them")
        n_vis = channels * rows
        print(f"  make_sharded_fused_flagger (K1 through the mesh) {medians['sharded_k1']:.3f} ms "
              f"against flag_dump's {medians['flag_dump']:.3f} (5 interleaved rounds of 3 calls, "
              f"CUDA events), {n_vis / medians['sharded_k1'] / 1e6:.3f} Gvis/s [{card}]")
        print(f"  make_sharded_flagger (1, 1), sum, baseline_block 1008: {staged_ms:.3f} ms "
              f"(CUDA events, 1 warm-up, median of 3), {n_vis / staged_ms / 1e6:.3f} Gvis/s "
              f"[{card}]")
        print(f"  get_flags_sharded at config 1: {medians_2d['sharded_2d']:.3f} ms against "
              f"get_flags' {medians_2d['single_2d']:.3f} ms (from and to the host; 7 interleaved "
              f"rounds of 1 call) [{card}]")
    finally:
        dist.destroy_process_group()
    print(f"  the phase took {time.perf_counter() - t0:.1f} s")


def run_harness(label: str, main, argv) -> str:
    """Run a harness's ``main`` in this process; returns what it printed.

    Its lines are printed indented; an exit code other than 0 raises.
    """
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(out):
        try:
            main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
    for line in out.getvalue().splitlines():
        print(f"    {line}")
    if code != 0:
        raise AssertionError(f"{label} {' '.join(argv)} exited with {code}")
    print(f"  {label} {' '.join(argv)}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out.getvalue()


def harness_ms(label: str, text: str) -> float:
    """The time a harness printed for its call on the card."""
    found = re.search(r"time on cuda(?::0)?: ([0-9.]+) ms/iter", text)
    if found is None:
        raise AssertionError(f"{label} printed no time on the card")
    return float(found.group(1))


# One call each of transposetest's and percentiletest's operation at the
# reference's sizes, each under its own torch.profiler session after a
# warm-up of both; prints the kernels each ran on the card, as JSON.
PROFILE_K4_K5 = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from katsdpsigproc_tpu_torch.ops import transpose as tr
from katsdpsigproc_tpu_torch.scripts import percentiletest, transposetest
cuda = torch.device("cuda", 0)
template = transposetest.make_template(cuda, "cuda")
planar = torch.randn((3072, 8320, 2), device=cuda)
op = percentiletest.make_op(cuda, (4000, 5000), "cuda")
values = torch.rand((4000, 5000), device=cuda)
calls = {"transposetest": lambda: tr.transpose(planar, template),
         "percentiletest": lambda: op(src=values)["dest"]}
for fn in calls.values():
    fn()
torch.cuda.synchronize()
names = {}
for label, fn in calls.items():
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names[label] = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))]
print(json.dumps(names))
"""


def phase_support(card: str) -> None:
    """Phase 12: the reference's harnesses at their default sizes (K5 and K4
    among them), the offline tuner, region copies and the test decorators."""
    from katsdpsigproc_tpu_torch.ops import percentile as pct, transpose as tr
    from katsdpsigproc_tpu_torch.scripts import (maskedsumabstest, maskedsumtest, percentiletest,
                                                 transposetest, tune_all)
    from katsdpsigproc_tpu_torch.test import test_accel
    from katsdpsigproc_tpu_torch.utils import regions
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    t0 = time.perf_counter()
    cuda = torch.device("cuda", 0)
    print(f"harnesses and support at the reference's sizes [{card}]:")
    times = {}
    iters = ["--iters", "20"]

    # K5: the corner turn of 3072 x 8320 complex64, planar.
    tr.launches["transpose"] = 0
    text = run_harness("transposetest", transposetest.main, ["--engine", "cuda"] + iters)
    launched = tr.launches["transpose"]
    print(f"  K5 launches during transposetest: {launched} (1 checked call, 2 warm-ups, "
          "20 timed)")
    if "Mismatches: 0 / 25559040" not in text or launched != 23:
        raise AssertionError("transposetest did not turn every element with K5 once a call")
    times["transposetest (K5)"] = (harness_ms("transposetest", text), 2 * 3072 * 8320 * 8)

    # K4: the percentiles of 4000 x 5000 float32.
    pct.launches["percentile5"] = 0
    text = run_harness("percentiletest", percentiletest.main, ["--engine", "cuda"] + iters)
    launched = pct.launches["percentile5"]
    print(f"  K4 launches during percentiletest: {launched} (1 checked call, 2 warm-ups, "
          "20 timed)")
    if "exact match vs np.percentile(..., 'lower')" not in text or launched != 23:
        raise AssertionError("percentiletest did not match numpy exactly with K4 once a call")
    times["percentiletest (K4)"] = (harness_ms("percentiletest", text),
                                    4000 * 5000 * 4 + 5 * 4000 * 4)

    # One call of each harness's op under torch.profiler, in a process of
    # its own: in this one, after the profiler sessions of phases 10 and 11,
    # the profiler was seen to trace no kernel of K4's or K5's library.
    proc = subprocess.run([sys.executable, "-c", PROFILE_K4_K5], cwd=ROOT, check=True,
                          capture_output=True, text=True, timeout=300)
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    for label, want in (("transposetest", "transpose_kernel"),
                        ("percentiletest", "percentile5_radix_kernel")):
        print(f"  kernels of one {label} call under torch.profiler (a fresh process): "
              f"{names[label]}")
        if len(names[label]) != 1 or want not in names[label][0]:
            raise AssertionError(f"one {label} call is not one launch of {want}")

    # The masked sums (torch.matmul: no kernel of the port's own).
    for label, main, out_bytes in (("maskedsumtest", maskedsumtest.main, 5000 * 8),
                                   ("maskedsumabstest", maskedsumabstest.main, 5000 * 4)):
        text = run_harness(label, main, iters)
        if "Mismatches: 0 / " not in text:
            raise AssertionError(f"{label} is not within its tolerance")
        times[label] = (harness_ms(label, text), 4000 * 5000 * 8 + 4000 * 4 + out_bytes)

    # The offline tuner, into a table under build/.
    table = ROOT / "build" / "katsdpsigproc_tpu_torch" / "tuning_table.json"
    if table.exists():
        table.unlink()
    run_harness("tune_all", tune_all.main, ["--table", str(table)])
    written = json.loads(table.read_text())
    print(f"  tune_all wrote {len(written)} records to {table.relative_to(ROOT)}")

    # Region copies of a 3072 x 8320 complex64 region on the card.
    rs = np.random.RandomState(12)
    h_src = rs.standard_normal((3100, 8400, 2)).astype(np.float32).view(np.complex64)[..., 0]
    sr, dr = np.s_[10:3082, 40:8360], np.s_[100:3172, :]
    expected = np.zeros((3200, 8320), np.complex64)
    expected[dr] = h_src[sr]
    src = torch.from_numpy(h_src).to(cuda)
    dest = torch.zeros((3200, 8320), dtype=torch.complex64, device=cuda)
    checks = {"copy_region": regions.copy_region(src, dest, sr, dr).cpu().numpy(),
              "set_region": regions.set_region(torch.zeros_like(dest), h_src, dr, sr)
              .cpu().numpy()}
    got = np.zeros((3200, 8320), np.complex64)
    regions.get_region(src, got, sr, dr)
    checks["get_region"] = got
    for label, out in checks.items():
        bad = int((out.view(np.uint64) != expected.view(np.uint64)).sum())
        print(f"  regions.{label} of a 3072 x 8320 complex64 region on {cuda}: {bad} mismatching "
              f"elements of {out.size}")
        if bad:
            raise AssertionError(f"regions.{label} differs from numpy")
    times["regions.copy_region"] = (time_fn(lambda: regions.copy_region(src, dest, sr, dr)),
                                    2 * 3072 * 8320 * 8)
    del src, dest

    # The test decorators on the card.
    seen = []

    @test_accel.device_test
    @test_accel.cuda_test
    def on_card(context, device):
        seen.append((context.device, device))

    on_card()
    print(f"  device_test and cuda_test resolved to {seen}")
    if seen != [(cuda, cuda)]:
        raise AssertionError("device_test and cuda_test did not resolve to cuda:0")

    print(f"  times on {card} (the harnesses' CUDA events, median of 20 calls; bound: the "
          "bytes read and written once at 3.35 TB/s):")
    for label, (ms, nbytes) in times.items():
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"    {label}: {ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
              f"{bound / ms:.2f} of it [{card}]")
    print(f"  the phase took {time.perf_counter() - t0:.1f} s")


# The benchmark's cell of ingest's flagging with per-sample flags, and its seed here.
FULLFLAGS_CELL, FULLFLAGS_SEED = "l32k-fullflags", 2 ** 32 + 27


def phase_fullflags(card: str, check: Check) -> dict:
    """Phase 13: one dump of the l32k-fullflags cell against its reference, and K1's and K5's times.

    Alone, after phase 1: ``python3 -c 'import chip_smoke as c; c.phase_fullflags(c.phase_device(),
    c.Check())'``.
    """
    from flagbench import counts_ingest, harness, reference_ingest
    from flagbench.loops import fullflags
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff
    from katsdpsigproc_tpu_torch.ops import transpose as tr
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn

    t0 = time.perf_counter()
    cuda = torch.device("cuda", 0)
    spec = harness.load_spec(ROOT)
    entry, = [w for w in spec["workloads"] if w["name"] == FULLFLAGS_CELL]
    config = harness.load_config(spec, entry["config"], ROOT)
    traffic = dict(harness.load_traffic(entry["traffic"]), ring=1)
    flagger = config["flagger"]
    (vis,), (flags,) = fullflags.make_ring(FULLFLAGS_SEED, config, traffic, cuda)
    channels, rows = flags.shape
    n_vis = channels * rows
    print(f"the {FULLFLAGS_CELL} dump, {channels} x {rows}, seed {FULLFLAGS_SEED}: "
          f"{float((flags != 0).float().mean()) * 100:.2f}% of samples flagged on input [{card}]")

    def call():
        return ff.flag_dump(vis.transpose(0, 1), flags.transpose(0, 1), **flagger)

    modes, turns = dict(ff.k1_modes), tr.launches["transpose"]
    got = call()
    torch.cuda.synchronize()
    launched = {m: ff.k1_modes[m] - modes[m] for m in ff.K1_MODES}
    print(f"  K1 launches by mode {launched}, K5 launches {tr.launches['transpose'] - turns}")
    if launched != {"none": 0, "full": 1, "channel": 0} or tr.launches["transpose"] != turns + 2:
        raise AssertionError("flag_dump with FULL flags is not K5 twice and K1 once in FULL mode")
    want = reference_ingest.flag_dump(vis, flags, flagger)
    check.flags("flagger", f"{FULLFLAGS_CELL} dump: flag_dump (K5 x 2, K1 FULL) vs reference_ingest",
                got, want)
    del got, want
    vis_rows, flags_rows = tr.transpose_cuda(vis), tr.transpose_cuda(flags)
    times = {
        "K1 FULL mode (flag_transposed on the turned dump and flags)": (
            time_fn(lambda: ff.flag_transposed(vis_rows, flags_rows, **flagger)),
            counts_ingest.k1_full_bound_s(n_vis, flagger["width"], flagger["n_windows"])),
        "K5 1-byte turn of the flags": (
            time_fn(lambda: tr.transpose_cuda(flags)), counts_ingest.k5_flags_bound_s(n_vis)),
        "K5 float2 turn of the dump": (time_fn(lambda: tr.transpose_cuda(vis)),
                                       16 * n_vis / HBM_BYTES_PER_S),
        "the whole call (K5 x 2 + K1)": (time_fn(call), None),
    }
    print(f"  times on {card} (CUDA events, each alone, median of 10 calls after 2):")
    for label, (ms, bound_s) in times.items():
        share = "" if bound_s is None else (f", bound {bound_s * 1e3:.4f} ms, "
                                             f"{100 * bound_s * 1e3 / ms:.2f}% of it")
        print(f"    {label}: {ms:.3f} ms{share}")
    print(f"  the phase took {time.perf_counter() - t0:.1f} s")
    return {label: ms for label, (ms, _) in times.items()}


HYBRID_CELL, HYBRID_SEED = "l32k-hybrid", 2 ** 32 + 29


def phase_hybrid(card: str, check: Check) -> dict:
    """Phase 14: the l32k-hybrid dump's slabs through the background kernel, checked and timed.

    Alone, after phase 1: ``python3 -c 'import chip_smoke as c; c.phase_hybrid(c.phase_device(),
    c.Check())'``.  Returns the background kernel's record for the kernels line, over a whole
    dump's slabs.
    """
    from flagbench import counts_hybrid, data, harness, reference
    from katsdpsigproc_tpu_torch.models.rfi import device
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff
    from katsdpsigproc_tpu_torch.utils.profiling import time_fn, time_queued

    t0 = time.perf_counter()
    cuda = torch.device("cuda", 0)
    spec = harness.load_spec(ROOT)
    entry, = [w for w in spec["workloads"] if w["name"] == HYBRID_CELL]
    config = harness.load_config(spec, entry["config"], ROOT)
    traffic = harness.load_traffic(entry["traffic"])
    flagger, fn_kw = config["flagger"], config["flagger_fn"]
    width, n_windows = flagger["width"], flagger["n_windows"]
    block, fast = fn_kw["baseline_block"], fn_kw["background_fast"]
    vis = data.make_dump(data.generator(HYBRID_SEED, cuda), config["channels"], config["rows"],
                         traffic["data"], cuda)
    channels, rows = vis.shape[:2]
    starts = range(0, rows, block)
    print(f"the {HYBRID_CELL} dump, {channels} x {rows}, seed {HYBRID_SEED}, slabs of {block} "
          f"rows [{card}]")
    none = device.BackgroundFlags.NONE
    k2_kw = dict(n_sigma=flagger["n_sigma"], n_windows=n_windows, falloff=flagger["falloff"],
                 flag_value=flagger["flag_value"])

    def kernel(s):
        return ff.background_deviations(vis[:, s:s + block], None, width, False, none,
                                        fast_path=fast)

    def plain(s):
        return ff.background_deviations_plain(vis[:, s:s + block], None, width, False, none,
                                              fast_path=fast)

    for s in starts:
        check.exact("background", f"slab {s}:{s + block}: background kernel vs the plain "
                    f"background and turn", kernel(s), plain(s))
    fn = device.make_flagger_fn(width, flagger["n_sigma"], n_windows=n_windows,
                                threshold_falloff=flagger["falloff"],
                                flag_value=flagger["flag_value"], **fn_kw)
    before = dict(ff.launches)
    got = fn(vis)
    torch.cuda.synchronize()
    launched = {name: ff.launches[name] - before[name] for name in ff.launches}
    print(f"  launches during one dump of the cell's flagger: {launched}")
    if launched != {"flagger": 0, "madnz_threshold": len(starts), "background": len(starts)}:
        raise AssertionError("the hybrid engine is not one background and one K2 launch a slab")
    check.flags("background", f"{HYBRID_CELL} dump: the hybrid engine vs flagbench's reference",
                got.transpose(0, 1), reference.flag_dump(vis, flagger))
    del got

    # One slab, device-paced: the kernel, the stages it replaces, and the two after it.
    s = 3 * block
    dev_t = kernel(s)
    flags_t = ff.madnz_threshold(dev_t, **k2_kw)
    out = torch.empty((channels, rows), dtype=torch.uint8, device=cuda)
    slab_vis = channels * block
    bounds = {"background kernel": counts_hybrid.background_bound_s(slab_vis, width, n_windows),
              "K2 madnz_threshold": counts_hybrid.k2_bound_s(slab_vis, width, n_windows),
              "the flags' store": 2 * slab_vis / HBM_BYTES_PER_S}
    card_state("before the hybrid cell's timings")
    slab_ms, samples = time_queued({
        "background kernel": lambda: kernel(s),
        "plain background + torch's turn (the stages it replaces)": lambda: plain(s),
        "K2 madnz_threshold": lambda: ff.madnz_threshold(dev_t, **k2_kw),
        "the flags' store": lambda: out[:, s:s + block].copy_(flags_t.transpose(0, 1)),
    }, reps=7, iters=3)
    dump_ms = time_fn(lambda: [kernel(t) for t in starts][-1])
    plain_dump_ms = time_fn(lambda: [plain(t) for t in starts][-1])
    whole_ms = time_fn(lambda: fn(vis))
    card_state("after them")
    print(f"  one slab of {channels} x {block} on {card} (device-paced, median of 7 rounds of 3):")
    for label, ms in slab_ms.items():
        spread = max(samples[label]) - min(samples[label])
        bound = bounds.get(label)
        share = "" if bound is None else (f", bound {bound * 1e3:.4f} ms, "
                                          f"{100 * bound * 1e3 / ms:.2f}% of it")
        print(f"    {label}: {ms:.4f} ms (spread {spread:.4f}){share}")
    dump_bound = counts_hybrid.background_bound_s(channels * rows, width, n_windows) * 1e3
    print(f"  the background kernel over the dump's {len(starts)} slabs: {dump_ms:.3f} ms, bound "
          f"{dump_bound:.4f} ms, {100 * dump_bound / dump_ms:.2f}% of it (CUDA events)")
    print(f"  the plain background and turn over the same {len(starts)} slabs: "
          f"{plain_dump_ms:.3f} ms (CUDA events)")
    print(f"  the cell's flagger, one dump (background kernel, K2 and store a slab): "
          f"{whole_ms:.3f} ms, {channels * rows / whole_ms / 1e6:.3f} Gvis/s")
    print(f"  the phase took {time.perf_counter() - t0:.1f} s")
    ops = counts_hybrid.stage_ops_per_vis(counts_hybrid.BACKGROUND_STAGES, width, n_windows)
    return record(launched["background"], dump_ms, plain_dump_ms,
                  counts_hybrid.BACKGROUND_BYTES_PER_VIS * channels * rows, ops * channels * rows)


def main() -> None:
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    # Tuning results stay inside the checkout.
    os.environ["KATSDPSIGPROC_TPU_TORCH_TUNE_DB"] = str(
        ROOT / "build" / "katsdpsigproc_tpu_torch" / "tuning.json")
    from katsdpsigproc_tpu_torch.models.rfi import device, flagger_probe as fp
    from katsdpsigproc_tpu_torch.models.rfi import fused_flagger as ff, host
    from katsdpsigproc_tpu_torch.ops import percentile as pct, transpose as tr
    from katsdpsigproc_tpu_torch.scripts.common import meerkat_dump
    from katsdpsigproc_tpu_torch.utils import kernels

    check = Check()
    phase_build(ff, pct, tr, fp, kernels)
    phase_kernels(ff, device, check)
    wide_rows = phase_wide(ff, device, card, check)
    t0 = time.perf_counter()
    vis_np = meerkat_dump(CHANNELS, BASELINES * POLS)
    print(f"dump generated on the host in {time.perf_counter() - t0:.1f} s")
    phase_oracle(ff, device, host, vis_np, check)
    results = phase_main(ff, tr, device, vis_np, card, check)
    for name, wide in wide_rows.items():
        results[name]["wide_row"] = wide
    results.update(phase_ops(pct, tr, vis_np, card, check))
    phase_flagger_device(ff, vis_np, card, check)
    results.update(phase_probes(fp, ff, device, vis_np, card, check))
    results.update(phase_examples(card, check))
    results.update(phase_cost_probes(ff, device, vis_np, card, check))
    results.update(phase_twod_fft(ff, device, vis_np, card, check))
    phase_stream(ff, device, vis_np, card, check)
    phase_parallel(ff, device, vis_np, card, check)
    del vis_np
    phase_support(card)
    phase_fullflags(card, check)
    results["background"] = phase_hybrid(card, check)
    print(json.dumps({"kernels": [
        {"name": name, "route": ROUTES.get(name, "cuda"), "source": SOURCES[name],
         "replaces": REPLACES[name], "max_abs_err": check.max_abs_err[name], **numbers}
        for name, numbers in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
