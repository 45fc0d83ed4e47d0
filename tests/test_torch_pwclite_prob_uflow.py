"""The port's ``PWCLiteProb`` and ``PWCLiteUflow`` against ``arflow_tpu``'s
at the published widths on 2x64x128 pairs, in float64 with the JAX
package's TPU relayouts off, every output level of both directions:

- ``PWCLiteProb``: flow and log-variance per level;
- ``PWCLiteUflow`` with ``feature_norm``, both ``align_corners``, ``warp_pad``
  zeros and border, and ``reduce_dense`` true and false (two JAX
  compiles: each flag takes both values);
- ``model.dtype: bfloat16`` for the three types: float32 outputs within
  0.05 mean relative of float32, as ``tests/test_mixed_precision.py`` holds
  the JAX package's; ``int8`` raises.

``PWCLiteUflow``'s level dropout is in ``test_torch_pwclite_uflow_train.py``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import PWCLiteProb, PWCLiteUflow, get_model
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import (  # noqa: F401  (fixture: lite_env)
    draw_params,
    images,
    jax_forward,
    level_gaps,
    lite_env,
    max_abs,
    port_model,
    run_port,
)

# Same float64 math on both sides, the JAX resize weights in float64; only
# summation orders differ (measured: at most 3.6e-14 on PWCLiteProb's
# outputs up to 24.4, 2.0e-14 on PWCLiteUflow's flows up to 13.4).
ATOL = 1e-10
PROB = {"type": "pwclite_prob", "n_frames": 2}
UFLOW = {"type": "pwclite_uflow", "n_frames": 2}


def _check(cfg, res_t, res_j, n_levels, channels):
    assert sorted(res_t) == sorted(res_j) == ["flows_bw", "flows_fw"]
    for key in ("flows_fw", "flows_bw"):
        assert len(res_t[key]) == n_levels
        assert res_t[key][0].shape == (2, 64, 128, channels)
        gaps = level_gaps(res_t[key], res_j[key])
        assert max(gaps) < ATOL, (cfg, key, gaps)
    assert max_abs(res_j["flows_fw"]) > 1.0


def test_pwclite_prob_matches_jax(lite_env):
    params = draw_params(PROB, seed=6)
    imgs = images(2, seed=4)
    model = port_model(PROB, params)
    assert isinstance(model, PWCLiteProb)
    res_t = run_port(model, imgs, with_bk=True)
    _check(PROB, res_t, jax_forward(PROB, params, imgs, with_bk=True), 5, 4)
    # the log-variances: clamped at 10 per level before the 4x upsample
    # and its +2 log 4
    for f in res_t["flows_fw"]:
        assert float(f[..., 2:].max()) <= 10 + 2 * np.log(4) + 1e-12


@pytest.mark.parametrize("feature_norm,align_corners,warp_pad,reduce_dense", [
    (True, True, "zeros", True), (False, False, "border", False)])
def test_pwclite_uflow_matches_jax(lite_env, feature_norm, align_corners,
                                   warp_pad, reduce_dense):
    cfg = dict(UFLOW, feature_norm=feature_norm, align_corners=align_corners,
               warp_pad=warp_pad, reduce_dense=reduce_dense)
    params = draw_params(cfg, seed=7)
    imgs = images(2, seed=5)
    model = port_model(cfg, params)
    assert isinstance(model, PWCLiteUflow)
    res_t = run_port(model, imgs, with_bk=True)
    _check(cfg, res_t, jax_forward(cfg, params, imgs, with_bk=True), 6, 2)


BF16_REL = 0.05


@pytest.mark.parametrize("cfg", [
    {"type": "pwclite", "n_frames": 2}, {"type": "pwclite", "n_frames": 3},
    PROB, dict(UFLOW, feature_norm=True)])
def test_bf16_outputs_float32_near_float32(cfg):
    n = 3 if cfg["n_frames"] == 3 else 2
    imgs = images(n, seed=9, b=1, dtype=np.float32)
    m32 = get_model(Config(cfg), device="cpu", seed=1)
    m16 = get_model(Config(dict(cfg, dtype="bfloat16")), device="cpu")
    m16.load_state_dict(m32.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    res32, res16 = run_port(m32, imgs), run_port(m16, imgs)
    for a, b in zip(res16["flows_fw"], res32["flows_fw"]):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        rel = float((a.double() - b).abs().mean() / b.double().abs().mean())
        assert rel < BF16_REL, rel


@pytest.mark.parametrize("kind", ["pwclite", "pwclite_prob", "pwclite_uflow"])
def test_int8_raises(kind):
    # the JAX factory's refusal (arflow_tpu/models/__init__.py:_int8)
    with pytest.raises(NotImplementedError, match="has no int8 path"):
        get_model(Config({"type": kind, "n_frames": 2, "dtype": "int8"}),
                  device="cpu")
