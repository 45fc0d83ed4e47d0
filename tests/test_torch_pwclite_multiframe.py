"""The port's 3- and 5-frame ``PWCLite`` against ``arflow_tpu``'s at the
published widths on 2x64x128 frames, in float64 with the JAX package's TPU
relayouts off: the 3-frame fusion's flows 1 -> 2 and 1 -> 0, and the
5-frame network's windows without ``with_bk``, every output level; with
``with_bk`` in ``test_torch_pwclite_5frame.py`` (each 5-frame JAX compile
takes 10-20 s here)."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import (  # noqa: F401  (fixture: lite_env)
    check_5frame,
    draw_params,
    images,
    jax_forward,
    level_gaps,
    lite_env,
    max_abs,
    port_model,
    run_port,
)

# As test_torch_pwclite.py (measured: at most 1.1e-14 px on flows up to
# 7.5).
ATOL = 1e-10
CFG3 = {"type": "pwclite", "n_frames": 3}


@pytest.fixture(scope="module")
def params():
    return draw_params(CFG3, seed=5)


def test_pwclite_3frame_matches_jax(lite_env, params):
    imgs = images(3, seed=2)
    res_j = jax_forward(CFG3, params, imgs, with_bk=False)
    res_t = run_port(port_model(CFG3, params), imgs)
    assert sorted(res_t) == sorted(res_j) == ["flows_bw", "flows_fw"]
    for key in ("flows_fw", "flows_bw"):
        assert len(res_t[key]) == 5  # every level upsampled 4x
        assert res_t[key][0].shape == (2, 64, 128, 2)
        gaps = level_gaps(res_t[key], res_j[key])
        assert max(gaps) < ATOL, (key, gaps)
    assert max_abs(res_j["flows_fw"]) > 1.0


def test_pwclite_5frame_matches_jax(lite_env, params):
    check_5frame(params, with_bk=False)
