"""The port's hand-written CUDA kernels, their wrappers and launch counts."""

from arflow_tpu_torch.ops.cuda.cost_volume import COST_VOLUME, COST_VOLUME_BWD

KERNELS = (COST_VOLUME, COST_VOLUME_BWD)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
