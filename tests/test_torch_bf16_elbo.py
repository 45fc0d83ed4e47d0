"""One ELBO ``diag`` train step with ``model.dtype`` bfloat16 against the
JAX package's in bfloat16 (``configs/chairs_uflow_elbo.json``'s model,
dropout off, and loss, the same injected noise), the same weights, on a
1x64x96 textured pair, as ``test_torch_bf16_train.py`` holds the ``uflow``
step (``bf16_step_gaps``)."""

import json
import os

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np

from torch_bf16_util import bf16_step_gaps, jax_cost_volume_round_trip  # noqa: F401
from torch_port_util import H, W, few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_elbo_diag_bf16_step_matches_jax_bf16(monkeypatch):
    """Measured: the bfloat16 losses 4.44e-4 apart (JAX's 5.07e-4 from
    the float32 one); the step's gradients at cosine 0.516 with the float32
    ones (JAX's: 0.750); the network's VJP 6.61e-2 from JAX's (JAX's
    7.34e-2 from the float32 one), the worst parameter 0.120 against its
    8.2e-2."""
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    with open(os.path.join(REPO, "configs", "chairs_uflow_elbo.json")) as f:
        full = json.load(f)
    rs = np.random.RandomState(9)
    noise = {k: rs.randn(1, H // 4, W // 4, 2).astype(np.float32)
             for k in ("eps12", "eps21")}
    bf16_step_gaps(dict(full["model"], level_dropout=0.0),
                   dict(full["loss"], type="uflow_elbo"), noise)
