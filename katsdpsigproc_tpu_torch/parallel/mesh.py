"""Device meshes over ``torch.distributed`` ranks, and sharding helpers.

Port of ``katsdpsigproc_tpu/parallel/mesh.py`` (``make_mesh``,
``vis_sharding``, ``noise_sharding``, ``shard``, ``shard_with_spec``,
:23-78).  Where JAX runs one controller over a global array and
``shard_map`` calls the body once per device, the port runs one process
per rank, each on its own device:

* a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over
  global ranks, with the dim names :data:`BASELINE_AXIS` and
  :data:`CHANNEL_AXIS`; the collectives of :mod:`.collectives` run on a
  dim's subgroup (``mesh.get_group(CHANNEL_AXIS)``);
* a sharding is a *spec*, one entry per leading array axis: the mesh dim
  that axis is split over, or ``None`` to replicate it (trailing axes
  left out are replicated), as a JAX ``PartitionSpec`` names them;
* :func:`shard` takes the full host array, which every rank passes as
  every JAX process does, and returns this rank's shard on this rank's
  device; :func:`gather`, the counterpart of JAX's
  ``multihost_utils.process_allgather(..., tiled=True)``, returns the
  global array on every rank.

A rank's device is ``cuda:<rank % cards>`` (one process per card, the
process group on NCCL); it is the CPU only when the caller asks for it
(``device_type="cpu"``, the process group on gloo).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: Canonical dim names: baselines (data-parallel) and channels
#: (sequence-parallel analogue).
BASELINE_AXIS = "baseline"
CHANNEL_AXIS = "channel"

#: One mesh dim name (or ``None``, replicated) per leading array axis.
Spec = Tuple[Optional[str], ...]


def _device_type(device_type: Optional[str]) -> str:
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_type='cpu' to lay the mesh over "
                               "CPU ranks")
        device_type = "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return device_type


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (BASELINE_AXIS,),
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """Build a mesh over the ranks of the initialised process group.

    Port of ``katsdpsigproc_tpu/parallel/mesh.py::make_mesh``.  `devices`
    is a sequence of global ranks in increasing order (default: every
    rank); the mesh takes the first ``prod(shape)`` of them in row-major
    order, so each dim's subgroup ranks its members in mesh order.  With
    the default 1-D shape every rank shards the baseline axis; a 2-D
    ``shape=(nb, nc)`` with ``axis_names=("baseline", "channel")`` gives
    the hybrid layout used for very long spectra.  Every rank of the
    group must call this, in the same order as every other mesh, since it
    creates the dims' subgroups.  `device_type` is ``"cuda"`` (the
    default; this rank's card becomes the current device) or ``"cpu"``.
    """
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize or "
                           "torch.distributed.init_process_group first")
    if devices is None:
        devices = range(dist.get_world_size())
    devices = [int(d) for d in devices]
    if any(b <= a for a, b in zip(devices, devices[1:])):
        raise ValueError(f"devices must be ranks in increasing order, got {devices}")
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devices)}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    ranks = torch.tensor(devices[:n], dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of shards along the mesh dim `name`."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def vis_sharding(mesh: DeviceMesh, transposed: bool = False) -> Spec:
    """Spec of (channels, baselines) arrays (or (baselines, channels)).

    Port of ``katsdpsigproc_tpu/parallel/mesh.py::vis_sharding``.
    """
    names = mesh.mesh_dim_names
    axes = tuple(name if name in names else None for name in (CHANNEL_AXIS, BASELINE_AXIS))
    return axes[::-1] if transposed else axes


def noise_sharding(mesh: DeviceMesh) -> Spec:
    """Spec of per-baseline (baselines,) arrays.

    Port of ``katsdpsigproc_tpu/parallel/mesh.py::noise_sharding``.
    """
    return (BASELINE_AXIS if BASELINE_AXIS in mesh.mesh_dim_names else None,)


def shard(mesh: DeviceMesh, array, transposed: bool = False) -> torch.Tensor:
    """This rank's shard of a (channels, baselines)-shaped array.

    Port of ``katsdpsigproc_tpu/parallel/mesh.py::shard``: every rank
    passes the full (replicated) host array.
    """
    return shard_with_spec(mesh, array, vis_sharding(mesh, transposed))


def shard_with_spec(mesh: DeviceMesh, array, spec: Spec) -> torch.Tensor:
    """This rank's shard of `array` (numpy or tensor) under `spec`, on its device.

    Port of ``katsdpsigproc_tpu/parallel/mesh.py::shard_with_spec``.
    Every rank passes the full array; an axis split over a mesh dim must
    divide by that dim's size, as a JAX sharding requires.  The shard is
    a contiguous copy, never a view of `array`.
    """
    t = torch.as_tensor(array)
    coord = mesh.get_coordinate()
    for axis, name in enumerate(spec):
        if name is None:
            continue
        n = axis_size(mesh, name)
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} does not divide into the {n} "
                             f"shards of mesh dim {name!r}")
        size = t.shape[axis] // n
        t = t.narrow(axis, coord[mesh.mesh_dim_names.index(name)] * size, size)
    out = torch.empty(t.shape, dtype=t.dtype, device=local_device(mesh))
    return out.copy_(t)


def gather(mesh: DeviceMesh, local: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The global array whose shard under `spec` is `local`, on every rank.

    The counterpart of JAX's ``multihost_utils.process_allgather(x,
    tiled=True)``: an ``all_gather`` on the subgroup of each mesh dim in
    `spec`, the shards concatenated in mesh order.  Every rank of the
    mesh must call it.
    """
    out = local.contiguous()
    for axis, name in enumerate(spec):
        if name is None or axis_size(mesh, name) == 1:
            continue
        group = mesh.get_group(name)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=axis)
    return out
