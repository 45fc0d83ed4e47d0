"""Data pipeline of the port: dataset catalogs, host-side augmentation in
numpy and the threaded prefetch loader (copies of ``arflow_tpu/data``)."""

from arflow_tpu_torch.data.datasets import (  # noqa: F401
    Chairs,
    Chairs2,
    ConcatDataset,
    ImgSeqDataset,
    KITTIFlow,
    KITTIFlowMV,
    Sintel,
    SintelRaw,
    Things3D,
)
from arflow_tpu_torch.data.get_dataset import get_dataset  # noqa: F401
from arflow_tpu_torch.data.loader import DataLoader  # noqa: F401
