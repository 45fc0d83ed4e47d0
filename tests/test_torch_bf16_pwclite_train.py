"""One ``pwclite`` + ``unflow`` train step (the JAX package's own PWC-Lite
step, ``test_torch_pwclite_train.py``'s ``PWCLITE`` / ``UNFLOW``) with
``model.dtype`` bfloat16 against the JAX package's in bfloat16, the same
weights, on a 1x64x128 textured pair (``bf16_step_gaps``; the six levels
need sides that 64 divides). The JAX side runs its cost volume in float32
on the bfloat16 features, as its TPU path does, with its relayouts off
(``torch_pwclite_util.GATES_OFF``). The float32 side of each bound is the
port's float32 step, which ``test_torch_pwclite_train.py`` holds to JAX's
in float64. The ``pwclite_uflow`` + ``fullres`` step is in
``test_torch_bf16_pwclite_uflow_train.py``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_bf16_util import bf16_step_gaps, round_trip
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import GATES_OFF

SIZE = (64, 128)


@pytest.fixture
def jax_pwclite_round_trip(monkeypatch):
    """The JAX PWC-Lite models' cost volume as the TPU runs it (float32 on
    bfloat16 features), their relayouts off."""
    import arflow_tpu.models.pwclite as jax_pwclite
    import arflow_tpu.models.pwclite_uflow as jax_pwclite_uflow

    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_pwclite, "compute_cost_volume", round_trip)
    monkeypatch.setattr(jax_pwclite_uflow, "compute_cost_volume", round_trip)


def test_pwclite_unflow_bf16_step_matches_jax_bf16(jax_pwclite_round_trip):
    """Measured: the bfloat16 losses 5.85e-4 apart (JAX's 6.21e-3 from
    the float32 one); the step's gradients at cosine 0.99998 with the
    float32 ones; the network's VJP 7.33e-3 from JAX's (JAX's 1.08e-2
    from the float32 one), the worst parameter (``conv_1x1.2.0.bias``)
    3.57e-2 against its 2.91e-2."""
    from test_torch_pwclite_train import PWCLITE, UNFLOW

    bf16_step_gaps(PWCLITE, UNFLOW, None, size=SIZE)
