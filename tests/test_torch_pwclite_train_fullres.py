"""One ``pwclite_uflow`` + ``fullres`` training step of
``arflow_tpu_torch`` against ``arflow_tpu`` (``check_step`` of
``test_torch_pwclite_train.py``): the loss terms and every parameter's
gradient at the published widths on a 2x64x64 pair in float64, the
``wang`` occlusion at 0.2, border warps, the ternary term on."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from test_torch_pwclite_train import FULLRES, PWCLITE_UFLOW, check_step
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import lite_env  # noqa: F401  (fixture)


def test_pwclite_uflow_fullres_step_matches_jax(lite_env):
    check_step(PWCLITE_UFLOW, FULLRES)
