"""Data parallelism over ``torch.distributed`` (port of
``arflow_tpu/parallel``), and the spatial (image-height) sharding of the
UFlow forward and of its training objective with hand-written row halos
(``parallel/spatial.py``)."""

from arflow_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_sum,
    average_grads,
    batch_group,
    batch_mean,
    batch_rows,
    batch_sum,
    data_parallel,
    dp_axes,
    gather_rows,
    group_sums,
    initialize_multihost,
    local_device,
    local_rows,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_batch,
    world_size,
)

from arflow_tpu_torch.parallel.spatial import (  # noqa: F401
    SPATIAL_NOT_PORTED,
    gather_flows,
    make_spatial_mesh,
    row_range,
    shard_images_spatial,
    spatial_forward,
    spatial_image_sharding,
    spatial_uflow_loss,
    spatial_value_and_grad,
)
