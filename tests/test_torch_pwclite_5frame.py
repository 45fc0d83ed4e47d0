"""The port's 5-frame ``PWCLite`` with ``with_bk`` against
``arflow_tpu``'s at the published widths on 2x64x128 frames, in float64
with the JAX package's TPU relayouts off, every output level of the three
windows (``torch_pwclite_util.check_5frame``). Without ``with_bk``: in
``test_torch_pwclite_multiframe.py``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import check_5frame, draw_params, lite_env  # noqa: F401


def test_pwclite_5frame_with_bk_matches_jax(lite_env):
    check_5frame(draw_params({"type": "pwclite", "n_frames": 3}, seed=5),
                 with_bk=True)
