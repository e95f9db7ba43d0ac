"""The port's multi-device layer: counterpart of ``tpupose/parallel/``.

``sharding`` (the ``Mesh`` of devices, batch splitting and padding),
``distributed`` (the ``torch.distributed`` process group), ``inference``
(the data-parallel estimator), ``pyramid`` (scales over devices) and
``spatial`` (image tiles with halos over devices).
"""

from tpupose_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch,
)
from tpupose_torch.parallel.sharding import data_mesh_for_batch  # noqa: F401
