"""One ``uflow`` train step with ``model.dtype`` bfloat16 against the JAX
package's in bfloat16 (``configs/chairs_uflow.json``'s model, dropout off,
``UFlowLoss`` with smooth order 1), the same weights, on a 1x64x96
textured pair. The float32 side of each bound is the port's float32 step,
which the float32 and float64 tests hold to JAX's
(``test_torch_uflow_train_grads.py``). The ELBO ``diag`` step is in
``test_torch_bf16_elbo.py``; both use ``bf16_step_gaps``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_bf16_util import bf16_step_gaps, jax_cost_volume_round_trip  # noqa: F401
from torch_port_util import few_torch_threads  # noqa: F401

MODEL = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}
LOSS = {"type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
        "w_census": 1.0, "smooth_order": 1, "with_bk": True}


def test_uflow_bf16_step_matches_jax_bf16():
    """Measured: the bfloat16 losses 5.06e-4 apart (JAX's 7.73e-5 from
    the float32 one); the step's gradients at cosine 0.672 with the float32
    ones (JAX's: 0.092); the network's VJP 4.61e-2 from JAX's (JAX's
    6.64e-2 from the float32 one), the worst parameter 9.6e-2 against its
    8.1e-2."""
    bf16_step_gaps(MODEL, LOSS, None)
