"""Data and tensor parallelism over `torch.distributed` (counterpart of
`qea_ocr_tpu/parallel/`): the same names, one process a GPU."""

from qea_ocr_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    put_batch,
    put_replicated,
    replicated,
)
from qea_ocr_tpu_torch.parallel.multihost import (  # noqa: F401
    global_from_local,
    global_from_local_dim,
    local_batch_size,
    local_rows,
    pinned_subset,
    process_sum,
    put_batch_global,
    shard_indices_for_host,
)
from qea_ocr_tpu_torch.parallel.tp import (  # noqa: F401
    MODEL_AXIS,
    make_mesh_2d,
    put_batch_2d,
    put_tp,
    tp_spec,
)
