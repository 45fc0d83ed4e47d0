"""One ``pwclite_uflow`` + ``fullres`` train step with ``model.dtype``
bfloat16 against the JAX package's in bfloat16 (``bf16_step_gaps`` at
1x64x128, level dropout off), as ``test_torch_bf16_pwclite_train.py``
holds the ``pwclite`` + ``unflow`` step: the same weights, the JAX cost
volume's float32 round trip, its relayouts off. The float32 side of each
bound is the port's float32 step, which
``test_torch_pwclite_train_fullres.py`` holds to JAX's in float64."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from test_torch_bf16_pwclite_train import SIZE, jax_pwclite_round_trip  # noqa: F401
from torch_bf16_util import bf16_step_gaps
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)


def test_pwclite_uflow_fullres_bf16_step_matches_jax_bf16(jax_pwclite_round_trip):
    """Measured: the bfloat16 losses 2.97e-4 apart (JAX's 8.47e-4 from
    the float32 one); the step's gradients at cosine 0.918 with the
    float32 ones; the network's VJP 6.27e-2 from JAX's (JAX's 6.25e-2 from
    the float32 one), the worst parameter
    (``feature_pyramid_extractor.convs.2.1.0.bias``) 0.105 against its
    6.25e-2."""
    from test_torch_pwclite_train import FULLRES, PWCLITE_UFLOW

    bf16_step_gaps(dict(PWCLITE_UFLOW, level_dropout=0.0), FULLRES, None, size=SIZE)
