"""Multi-process bring-up helpers.

Port of ``katsdpsigproc_tpu/parallel/multihost.py`` (:22-78) on
``torch.distributed``: one process per card (or, on the CPU, per rank),
all joined in one process group, with every collective of
:mod:`.collectives` on a mesh dim's subgroup: NCCL over NVLink within a
host and the network across hosts, gloo on the CPU.  Failure model: a
multi-process run fails fast; any process error aborts the job, with no
elastic recovery.
"""

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import mesh as mesh_mod


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> None:
    """Join this process to the job's process group (a no-op for one process).

    Port of ``katsdpsigproc_tpu/parallel/multihost.py::initialize`` over
    ``torch.distributed.init_process_group``.  `coordinator_address` is
    ``host:port`` of rank 0's store (a ``tcp://`` address) or any
    ``init_method`` URL, such as ``file:///shared/path``; without it the
    address, size and rank come from the environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  `backend`
    is ``"nccl"`` for the cards, ``"gloo"`` for CPU ranks.  Idempotent
    when a process group already exists; any other failure raises.  A
    job of one process needs a group of its own for a mesh
    (``init_process_group`` with a ``TCPStore`` on 127.0.0.1).
    """
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes or -1,
                            rank=-1 if process_id is None else process_id)


def pod_mesh(baseline_shards: Optional[int] = None, channel_shards: int = 1,
             device_type: Optional[str] = None) -> DeviceMesh:
    """The (baseline, channel) mesh over every rank of the process group.

    Port of ``katsdpsigproc_tpu/parallel/multihost.py::pod_mesh``.
    Baselines shard over ``baseline_shards`` (default: every rank /
    `channel_shards`); the channel dim takes adjacent ranks, so halo
    exchanges stay within a host.  `device_type` as in
    :func:`.mesh.make_mesh`.
    """
    n = dist.get_world_size()
    if baseline_shards is None:
        baseline_shards = n // channel_shards
    if baseline_shards * channel_shards != n:
        raise ValueError(f"mesh {baseline_shards}x{channel_shards} != device count {n}")
    return mesh_mod.make_mesh((baseline_shards, channel_shards),
                              (mesh_mod.BASELINE_AXIS, mesh_mod.CHANNEL_AXIS),
                              device_type=device_type)


def process_summary() -> str:
    """Human-readable placement summary for logs (process 0/1 without a group).

    Port of ``katsdpsigproc_tpu/parallel/multihost.py::process_summary``;
    each process drives one device.
    """
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return f"process {rank}/{world}, 1 local of {world} devices"
