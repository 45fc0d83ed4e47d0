"""Tensor ops of the UFlow and PWC-Lite paths (NCHW)."""

from arflow_tpu_torch.ops.census import (  # noqa: F401
    abs_robust_loss,
    census_loss,
    census_transform,
    rgb_to_grayscale,
    robust_l1,
    soft_hamming,
    zero_mask_border,
)
from arflow_tpu_torch.ops.cost_volume import (  # noqa: F401
    compute_cost_volume,
    compute_cost_volume_reference,
    normalize_features,
)
from arflow_tpu_torch.ops.occlusion import (  # noqa: F401
    compute_range_map,
    get_corresponding_map,
    get_occu_mask_backward,
    get_occu_mask_bidirection,
)
from arflow_tpu_torch.ops.resize import (  # noqa: F401
    downsample,
    image_grads,
    resize_area,
    resize_bilinear,
    resize_flow,
    upsample,
)
from arflow_tpu_torch.ops.ssim import ssim_dist, ssim_loss  # noqa: F401
from arflow_tpu_torch.ops.warp import (  # noqa: F401
    bilinear_gather_with_grads,
    border_mask,
    flow_to_warp,
    flow_warp,
    mask_invalid,
    resample,
    resample_with_grads,
)
