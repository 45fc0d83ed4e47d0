"""The port's 2-frame ``PWCLite`` against ``arflow_tpu``'s at the published
widths on 2x64x128 pairs, in float64 with the JAX package's TPU relayouts
off: every output level of both directions, for ``reduce_dense`` and
``upsample`` each true and false (two JAX compiles; the other two
combinations are held to these through the port, where ``upsample`` only
adds the 4x upsample in front). The 3- and 5-frame networks are in
``test_torch_pwclite_multiframe.py``, ``PWCLiteProb`` and ``PWCLiteUflow``
in ``test_torch_pwclite_prob_uflow.py``, the converters in
``test_torch_pwclite_weights.py``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import arflow_tpu.ops.resize as jax_resize
from arflow_tpu_torch.models import PWCLite
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import (  # noqa: F401  (fixture: lite_env)
    draw_params,
    images,
    jax_forward,
    level_gaps,
    lite_env,
    max_abs,
    port_model,
    resize_matrix_f64,
    run_port,
)

# Same float64 math on both sides, the JAX resize weights in float64
# (torch_pwclite_util.resize_matrix_f64); only summation orders differ
# (measured: at most 1.1e-14 px on flows up to 8.0).
ATOL = 1e-10


@pytest.mark.parametrize("sizes", [(1, 2), (2, 8), (4, 16), (16, 4), (6, 7)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_f64_resize_weights_round_to_jax(sizes, align_corners):
    """The float64 weights the JAX side runs with here are the JAX
    package's own, before its rounding to float32."""
    ours = resize_matrix_f64(*sizes, "bilinear", align_corners)
    theirs = jax_resize._resize_matrix.__wrapped__(*sizes, "bilinear",
                                                   align_corners)
    np.testing.assert_array_equal(ours.astype(np.float32), theirs)


@pytest.mark.parametrize("reduce_dense,upsample", [(True, True),
                                                   (False, False)])
def test_pwclite_2frame_matches_jax(lite_env, reduce_dense, upsample):
    cfg = {"type": "pwclite", "n_frames": 2, "reduce_dense": reduce_dense,
           "upsample": upsample}
    params = draw_params(cfg, seed=int(reduce_dense) + 2 * int(upsample))
    imgs = images(2, seed=1)
    res_j = jax_forward(cfg, params, imgs, with_bk=True)
    model = port_model(cfg, params)
    assert isinstance(model, PWCLite)
    res_t = run_port(model, imgs, with_bk=True)
    assert sorted(res_t) == sorted(res_j) == ["flows_bw", "flows_fw"]
    n_levels = 6 if upsample else 5
    for key in ("flows_fw", "flows_bw"):
        assert len(res_t[key]) == n_levels
        assert res_t[key][0].shape == (2, 64 if upsample else 16,
                                       128 if upsample else 32, 2)
        gaps = level_gaps(res_t[key], res_j[key])
        assert max(gaps) < ATOL, (key, gaps)
    # The flows are not trivially small: the levels carry the estimates.
    assert max_abs(res_j["flows_fw"]) > 1.0
    # without with_bk: the forward flows alone, the same values
    fw = run_port(model, imgs, with_bk=False)
    assert sorted(fw) == ["flows_fw"]
    for a, b in zip(fw["flows_fw"], res_t["flows_fw"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the other upsample: the same weights, the levels below the 4x one
    other = port_model(dict(cfg, upsample=not upsample), params)
    res_o = run_port(other, imgs, with_bk=True)
    for key in ("flows_fw", "flows_bw"):
        ups, plain = ((res_t, res_o) if upsample else (res_o, res_t))
        assert len(ups[key]) == len(plain[key]) + 1
        for a, b in zip(ups[key][1:], plain[key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pwclite_refuses_a_frame_count_it_has_no_weights_for():
    model = port_model({"type": "pwclite", "n_frames": 2},
                       draw_params({"type": "pwclite", "n_frames": 2}))
    with pytest.raises(ValueError, match="takes 2 frames, got 3"):
        run_port(model, images(3, seed=0))
    with pytest.raises(ValueError, match="n_frames 4"):
        PWCLite(n_frames=4)
