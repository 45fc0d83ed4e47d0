"""ARFlow on PyTorch and CUDA: the port of ``arflow_tpu`` to an NVIDIA H100.

The package mirrors ``arflow_tpu``'s module names (``ops/``, ``models/``,
``losses/``, ``training/``, ``serving/``, ``utils/``, ``config.py``) and
imports nothing of it, nor of JAX. Inside
the network tensors are NCHW; the public entry points take and return NHWC
like the JAX package (images ``(B,H,W,3)`` in [0,1], flows ``(B,H,W,2)``
with ``[..., 0] = u``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of dropping to the CPU.
Every Pallas kernel of ``arflow_tpu`` on the ported path has a hand-written
CUDA counterpart under ``csrc/``, its backward included (built at first
use, see ``ops/cuda/build.py``); on a CPU tensor the same entry points run
the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from arflow_tpu_torch.config import Config, load_config  # noqa: F401
from arflow_tpu_torch.device import resolve_device  # noqa: F401
