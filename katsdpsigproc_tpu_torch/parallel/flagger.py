"""Multi-rank RFI flaggers: baseline and channel sharding with collectives.

Port of ``katsdpsigproc_tpu/parallel/flagger.py`` (:43-253).  The
flagger pipeline runs on every rank of a 2-D ``(baseline, channel)`` mesh
(:mod:`.mesh`), each on its local shard:

* **Baseline sharding**: each rank flags its own baselines over the full
  band, with no communication at all.
* **Channel sharding** (the sequence-parallel analogue for very long
  spectra), three exact communication patterns:

  - background median filter: a ``width // 2``-channel halo exchange
    before the windowed median;
  - MAD noise: the bitwise rank search with summed counts
    (:func:`.collectives.median_non_zero`), distributed without
    gathering;
  - SumThreshold: an ``EDGE_SIZE = 2**w - w - 1`` halo (the reference's
    chunk-overlap bound) and a local run over the extended block,
    cropped to the interior.

The per-shard maths is the single-device stages of
:mod:`..models.rfi.device`, as JAX reuses its own, so parity with one
device carries over shard for shard.  :func:`make_sharded_fused_flagger`
runs K1 (``fused_flagger.flag_dump``) on each baseline shard instead.
"""

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.rfi import MAD_NORMAL, device as rfi_device, fused_flagger
from ..ops import rank as rank_ops
from . import collectives
from .mesh import BASELINE_AXIS, CHANNEL_AXIS, axis_size


def make_sharded_flagger(
    mesh: DeviceMesh,
    width: int = 13,
    n_sigma: float = 11.0,
    is_amplitude: bool = False,
    use_flags: rfi_device.BackgroundFlags = rfi_device.BackgroundFlags.NONE,
    threshold: str = "sum",
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    baseline_block: Optional[int] = None,
):
    """Build the multi-rank flagger over `mesh`.

    Port of ``katsdpsigproc_tpu/parallel/flagger.py::make_sharded_flagger``.
    The mesh must name the ``baseline`` dim and may name a ``channel``
    dim (size 1 reduces to pure baseline sharding).  Returns
    ``flags = fn(vis[, input_flags])``, which every rank of the mesh calls
    on its shard of the (channels, baselines) visibilities (complex,
    planar (channels, baselines, 2) float32, or amplitudes), as
    ``mesh.shard`` gives it; CHANNEL input flags are (channels,) sharded
    over the channel dim only, FULL flags are sharded as the visibilities.
    Returns this rank's (channels, baselines) uint8 flags.

    ``baseline_block`` runs each shard's local baselines in sequential
    blocks, the collectives once a block: every rank runs the same number
    of blocks, so the reduction and halo schedules stay aligned.  Ignored
    unless it divides the local baseline count.
    """
    names = mesh.mesh_dim_names or ()
    if BASELINE_AXIS not in names:
        raise ValueError(f"mesh must name a {BASELINE_AXIS!r} axis")
    group = mesh.get_group(CHANNEL_AXIS) if CHANNEL_AXIS in names else None
    channel_shards = axis_size(mesh, CHANNEL_AXIS) if group is not None else 1
    h = width // 2
    edge = (1 << n_windows) - n_windows - 1  # reference EDGE_SIZE

    def flag_block(amp_ext, c_local: int, n_channels: int):
        """Background, noise and threshold on one (C_ext, b) block; (b, C_local) flags."""
        # The filter re-pads internally; feed it the extended block and keep
        # the interior rows, which only ever see real neighbour data.
        med_ext, _ = rfi_device.masked_median_filter(amp_ext, width)
        amp = amp_ext[h:h + c_local]
        deviations = amp - med_ext[h:h + c_local]
        deviations = torch.where(torch.isnan(deviations), 0.0, deviations).to(torch.float32)

        dev_t = deviations.transpose(0, 1).contiguous()  # (b, C_local)
        values = dev_t.abs()
        if group is not None:
            med = collectives.median_non_zero(values, n_channels, group)
        else:
            med = rank_ops.median_non_zero(values, n_channels)
        noise = (MAD_NORMAL * med).to(torch.float32)

        if threshold == "simple":
            return rfi_device.threshold_simple(dev_t, noise, n_sigma, flag_value, True)
        if group is not None:
            dev_t_ext = collectives.halo_exchange(dev_t, edge, group, 0.0, axis=1)
            flags_ext = rfi_device.threshold_sum(dev_t_ext, noise, n_sigma, n_windows,
                                                 threshold_falloff, flag_value)
            return flags_ext[:, edge:edge + c_local] if edge else flags_ext
        return rfi_device.threshold_sum(dev_t, noise, n_sigma, n_windows, threshold_falloff,
                                        flag_value)

    def flagger(vis, input_flags=None):
        if use_flags and input_flags is None:
            raise TypeError("flags were expected but not provided")
        if not use_flags and input_flags is not None:
            raise TypeError("flags were provided but not included in the template")
        if is_amplitude:
            amp = vis.to(torch.float32)
            invalid = amp < 0
        else:
            amp = rfi_device.amplitude(vis)
            invalid = torch.zeros(amp.shape, dtype=torch.bool, device=amp.device)
        if use_flags == rfi_device.BackgroundFlags.CHANNEL:
            invalid = invalid | (input_flags != 0)[:, None]
        elif use_flags == rfi_device.BackgroundFlags.FULL:
            invalid = invalid | (input_flags != 0)
        amp = torch.where(invalid, math.nan, amp)
        c_local, b_local = amp.shape
        if group is not None:
            amp_ext = collectives.halo_exchange(amp, h, group, math.nan, axis=0)
        else:
            amp_ext = torch.nn.functional.pad(amp, (0, 0, h, h), value=math.nan)
        n_channels = c_local * channel_shards
        if baseline_block and b_local % baseline_block == 0 and b_local > baseline_block:
            flags_t = torch.cat([
                flag_block(amp_ext[:, s:s + baseline_block], c_local, n_channels)
                for s in range(0, b_local, baseline_block)])
        else:
            flags_t = flag_block(amp_ext, c_local, n_channels)
        return flags_t.transpose(0, 1)

    return flagger


def make_sharded_fused_flagger(
    mesh: DeviceMesh,
    width: int = 13,
    n_sigma: float = 11.0,
    slab: int = 256,
    bb: int = 8,
    fold: int = 8192,
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    pipeline: str = "grid",
    interpret: bool = False,
    axis_name: Optional[str] = None,
    ingest: str = "planar",
):
    """The fused flagger (K1) on each rank's baseline shard.

    Port of ``katsdpsigproc_tpu/parallel/flagger.py::make_sharded_fused_flagger``.
    Each rank runs :func:`..models.rfi.fused_flagger.flag_dump` on its own
    baseline shard, with no collective: K1 on a CUDA tensor, its plain
    version on a CPU one.  The channel axis stays whole; for channel
    sharding use :func:`make_sharded_flagger`.

    Returns ``fn(vis_t[, input_flags])``, which every rank calls on its
    shard of the baseline-major planar ``(baselines, channels, 2)``
    float32 dump (``mesh.shard_with_spec(mesh, vis_t, (axis_name,))``),
    and which returns that shard's ``(baselines, channels)`` uint8 flags.
    The baselines must divide by the shard count times ``bb``, as in JAX.
    ``slab``, ``fold``, ``pipeline`` and ``interpret`` are accepted and
    ignored, as ``flag_dump`` ignores them; ``ingest`` is passed on.
    """
    axis = axis_name or BASELINE_AXIS
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh must name a {axis!r} axis")
    n_shards = axis_size(mesh, axis)
    kw = dict(slab=slab, width=width, n_sigma=n_sigma, n_windows=n_windows,
              falloff=threshold_falloff, flag_value=flag_value, bb=bb, fold=fold,
              pipeline=pipeline, interpret=interpret, ingest=ingest)

    def flagger(vis_t, input_flags=None):
        if vis_t.shape[0] % bb:
            raise ValueError(
                f"baselines ({vis_t.shape[0] * n_shards}) must divide by shards*bb "
                f"({n_shards}*{bb})")
        return fused_flagger.flag_dump(vis_t, input_flags, **kw)

    return flagger
