"""Device-mesh sharding and collective reductions on ``torch.distributed``.

Port of ``katsdpsigproc_tpu/parallel``: one process per rank, each
running the same call on its local shard (see :mod:`.mesh`).
"""

from . import collectives, flagger, mesh, multihost  # noqa: F401

__all__ = ["collectives", "flagger", "mesh", "multihost"]
