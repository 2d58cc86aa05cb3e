"""Multi-rank RFI flagging on a device mesh.

Port of ``doc/examples/sharded_flagger.py``.  It starts one process per
rank, joins them in one process group (NCCL on the cards, gloo on the
CPU) and runs both sharded pipelines of :mod:`..parallel`:

* the 1-D flagger with baselines as data parallelism and channels as the
  sequence-parallel axis (halo exchanges and collective noise
  estimates), on a (2, N/2) mesh, against the numpy host oracle;
* the 2-D time-frequency flagger with baselines sharded (no
  collectives), against the single-device ``get_flags``.

Run::

    python -m katsdpsigproc_tpu_torch.examples.sharded_flagger [--device cpu] [--world-size N]

On the card the world is every card of the host (``--world-size``
defaults to ``torch.cuda.device_count()``); on the CPU it is 8 ranks, as
the JAX example's 8 virtual devices.
"""

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models.rfi import host as rfi_host, twodflag
from ..parallel import flagger as pflagger, mesh as pmesh
from . import parser


def flag(device_type: str) -> None:
    """Both halves on this rank; rank 0 prints.  Every rank must call it."""
    world, rank = dist.get_world_size(), dist.get_rank()

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    say(f"devices: {world} × {device_type}")

    # --- 1-D flagger over a (baseline × channel) mesh -------------------
    nb = 2 if world % 2 == 0 else 1
    nc = world // nb
    m = pmesh.make_mesh((nb, nc), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS),
                        device_type=device_type)
    rs = np.random.RandomState(seed=1)
    channels, baselines = -(-256 // nc) * nc, 16
    vis = (rs.standard_normal((channels, baselines))
           + 1j * rs.standard_normal((channels, baselines))).astype(np.complex64)
    vis[100, :] *= 50.0  # planted spike

    fn = pflagger.make_sharded_flagger(m, width=13, n_sigma=11.0, threshold="sum")
    local = fn(pmesh.shard(m, vis))
    flags = pmesh.gather(m, local, pmesh.vis_sharding(m)).cpu().numpy()

    host_flagger = rfi_host.FlaggerHost(
        rfi_host.BackgroundMedianFilterHost(13),
        rfi_host.NoiseEstMADHost(),
        rfi_host.ThresholdSumHost(11.0),
    )
    expected = host_flagger(np.abs(vis))
    mismatches = int((flags != expected).sum())
    say(f"1-D sharded flagger on a ({nb}, {nc}) mesh: flagged {flags.sum()} / {flags.size}, "
        f"mismatches vs host oracle: {mismatches}")
    if mismatches:
        raise AssertionError(f"rank {rank}: {mismatches} mismatches vs the host oracle")

    # --- 2-D flagger, baselines sharded ---------------------------------
    m1 = pmesh.make_mesh((world,), (pmesh.BASELINE_AXIS,), device_type=device_type)
    shape = (32, 96, 12)
    data = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    data[10] *= 20.0
    in_flags = np.zeros(shape, np.bool_)

    flagger2d = twodflag.SumThresholdFlagger(freq_chunks=4)
    out = flagger2d.get_flags_sharded(data, in_flags, m1)
    expected2d = flagger2d.get_flags(data, in_flags, device=pmesh.local_device(m1))
    mismatches = int((out != expected2d).sum())
    say(f"2-D sharded flagger over {world} ranks: flagged fraction {out.mean():.4f}, "
        f"mismatches vs single-device: {mismatches}")
    if mismatches:
        raise AssertionError(f"rank {rank}: {mismatches} 2-D mismatches vs get_flags")


def _rank(rank: int, world: int, device_type: str, init_method: str) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world)
    try:
        flag(device_type)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--world-size", type=int, default=None,
                    help="ranks to start (default: every card, or 8 on the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run this example on the CPU")
    world = args.world_size or (torch.cuda.device_count() if args.device == "cuda" else 8)
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        mp.spawn(_rank, args=(world, args.device, init_method), nprocs=world)


if __name__ == "__main__":
    main()
