"""The port's host-side metrics (``arflow_tpu_torch/utils/metrics.py``)
against ``arflow_tpu.utils.metrics``: EPE and KITTI's masked E_noc, E_occ
and F1_all, the sparsification plot and its AUC, the calibration curve; and
the ``uflow`` trainer's ``valid_masks`` validation on the CPU."""

import logging

import numpy as np
import pytest
import torch

from arflow_tpu.utils import metrics as jax_metrics
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.utils import metrics
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

# Predictions at the ground truth's size go through the same numpy on both
# sides, bit for bit. Resized ones go through the port's 2-tap numpy resize
# where the JAX package uses cv2 (measured, 20x30 to 40x60: EPE equal, the
# AUCs and sparsification plots within 3.6e-6 relative, the calibration
# curve's means and sigmas within 2.5e-7).
RESIZE_RTOL = 1e-5


def kitti_gt(rs, n, h, w):
    """(h, w, 4) float32 ground truths: flow, occ mask, noc mask within it."""
    gts = []
    for _ in range(n):
        flow = rs.randn(h, w, 2).astype(np.float32) * 3
        occ = (rs.rand(h, w, 1) > 0.3).astype(np.float32)
        noc = occ * (rs.rand(h, w, 1) > 0.3).astype(np.float32)
        gts.append(np.concatenate([flow, occ, noc], axis=-1))
    return gts


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("pred_hw", [(40, 60), (20, 30)])
def test_evaluate_flow_matches_jax(masks, pred_hw):
    rs = np.random.RandomState(0)
    gts = (kitti_gt(rs, 3, 40, 60) if masks else
           [rs.randn(40, 60, 2).astype(np.float32) * 3 for _ in range(3)])
    # ~half the pixels within 3 px, so that F1_all counts both ways
    preds = [rs.randn(*pred_hw, 2).astype(np.float32) * 3 for _ in range(3)]
    ours = metrics.evaluate_flow(gts, preds)
    theirs = jax_metrics.evaluate_flow(gts, [p.copy() for p in preds])
    assert len(ours) == len(theirs) == (4 if masks else 1)
    rtol = 0 if pred_hw == (40, 60) else RESIZE_RTOL
    np.testing.assert_allclose(ours, theirs, rtol=rtol)
    # a batch tensor gives the same
    np.testing.assert_array_equal(
        metrics.evaluate_flow(torch.from_numpy(np.stack(gts)),
                              torch.from_numpy(np.stack(preds))), ours)


def test_sp_plot_matches_jax():
    rs = np.random.RandomState(1)
    error = np.abs(rs.randn(30, 40))
    entropy = rs.randn(30, 40)
    mask = (rs.rand(30, 40) > 0.2).astype(np.float64)
    for n in (10, 25):
        np.testing.assert_array_equal(
            metrics.sp_plot(error, entropy, mask, n=n),
            jax_metrics.sp_plot(error, entropy, mask, n=n))


@pytest.mark.parametrize("pred_hw", [(40, 60), (20, 30)])
def test_evaluate_uncertainty_matches_jax(pred_hw):
    rs = np.random.RandomState(2)
    gts = kitti_gt(rs, 2, 40, 60) + [rs.randn(40, 60, 2).astype(np.float32)]
    preds = [rs.randn(*pred_hw, 2).astype(np.float32) for _ in range(3)]
    # an entropy that tracks the error somewhat
    ents = [(np.abs(p) + 0.3 * rs.randn(*pred_hw, 2)).astype(np.float32)
            for p in preds]
    ours, splots, oracle = metrics.evaluate_uncertainty(gts, preds, ents, 11)
    theirs, splots_j, oracle_j = jax_metrics.evaluate_uncertainty(
        gts, [p.copy() for p in preds], [e.copy() for e in ents], 11)
    rtol = 0 if pred_hw == (40, 60) else RESIZE_RTOL
    np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=rtol)
    for a, b in zip(splots + oracle, splots_j + oracle_j):
        assert a.shape == b.shape == (11,)
        np.testing.assert_allclose(a, b, rtol=rtol)


def test_calibration_curve_matches_jax():
    rs = np.random.RandomState(3)
    gts = [rs.randn(24, 32, 2).astype(np.float32) for _ in range(2)]
    preds = [rs.randn(12, 16, 2).astype(np.float32) for _ in range(2)]
    ents = [rs.randn(24, 32, 2).astype(np.float32) * 0.5 for _ in range(2)]
    ours, theirs = metrics.CalibrationCurve(), jax_metrics.CalibrationCurve()
    ours(gts, preds, ents)
    theirs(gts, [p.copy() for p in preds], ents)
    vals, means, sigmas, numbers = ours.calibration_curve()
    vals_j, means_j, sigmas_j, numbers_j = theirs.calibration_curve()
    assert vals == vals_j and numbers == numbers_j
    assert sum(numbers) == 2 * 24 * 32 * 2
    np.testing.assert_allclose(means, means_j, rtol=RESIZE_RTOL)
    np.testing.assert_allclose(sigmas, sigmas_j, rtol=RESIZE_RTOL)


def test_uflow_trainer_validates_with_kitti_masks(tmp_path):
    """``valid_masks``: EPE, E_noc, E_occ and F1_all per validation set."""
    rs = np.random.RandomState(4)
    h, w = 64, 96
    valid = [{"img1": rs.rand(1, h, w, 3).astype(np.float32),
              "img2": rs.rand(1, h, w, 3).astype(np.float32),
              "target": {"flow": kitti_gt(rs, 1, h, w)[0][None]}}
             for _ in range(2)]
    cfg = Config({
        "model": {"type": "uflow"},
        # complete: validation's images run the loss for the occlusion mask
        "loss": {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0,
                 "smooth_order": 1, "edge_constant": 150.0, "with_bk": True},
        "train": {"valid_size": 10, "print_freq": 1, "valid_masks": True,
                  "save_iter": 10**9, "epoch_size": 1}})
    model = get_model(cfg.model, device="cpu", seed=1)
    tr = get_trainer("uflow")([], [valid], model, get_loss(cfg.loss),
                              logging.getLogger("test"), str(tmp_path),
                              cfg.train, model_cfg=cfg.model, full_cfg=cfg)
    errors, names = tr._validate_with_gt()
    assert names == ["EPE_0", "E_noc_0", "E_occ_0", "F1_all_0"]
    with torch.no_grad():
        preds = [model(torch.from_numpy(v["img1"]), torch.from_numpy(v["img2"]),
                       with_bk=False)["flows_fw"][0][0].numpy() for v in valid]
    want = np.mean([jax_metrics.evaluate_flow(list(v["target"]["flow"]), [p])
                    for v, p in zip(valid, preds)], axis=0)
    np.testing.assert_allclose(errors, want, rtol=1e-6)
    assert np.isfinite(errors).all() and errors[3] > 0
