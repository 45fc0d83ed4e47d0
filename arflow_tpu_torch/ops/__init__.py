"""Tensor ops of the UFlow path (NCHW)."""

from arflow_tpu_torch.ops.cost_volume import (  # noqa: F401
    compute_cost_volume,
    compute_cost_volume_reference,
    normalize_features,
)
from arflow_tpu_torch.ops.resize import (  # noqa: F401
    downsample,
    resize_bilinear,
    upsample,
)
from arflow_tpu_torch.ops.warp import (  # noqa: F401
    flow_to_warp,
    mask_invalid,
    resample,
)
