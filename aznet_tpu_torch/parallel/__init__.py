"""Multi-device runs over ``torch.distributed`` (``aznet_tpu/parallel``):
the ``('data', 'model')`` mesh and its sharding rules (``mesh.py``),
sharded and region-parallel inference (``inference.py``), and the
multi-host launcher and dry run (``multihost.py``)."""

from aznet_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    param_sharding,
    replicate,
)
