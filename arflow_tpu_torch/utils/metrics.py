"""Flow accuracy and uncertainty metrics on the host, in numpy (port of
``arflow_tpu/utils/metrics.py``): EPE, and with KITTI's occlusion masks
E_noc, E_occ and F1_all; soft-threshold sparsification plots and their AUC
against the oracle's; calibration curves.

A prediction of another size than its ground truth is rescaled (values by
the size ratio) and resized bilinearly with ``resize_bilinear_np``, the
2-tap numpy resize, where the JAX package uses cv2.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from arflow_tpu_torch.ops.resize import resize_bilinear_np


def _samples(batch) -> list:
    """A batch tensor (any device), an array or a list -> numpy samples."""
    if isinstance(batch, torch.Tensor):
        batch = batch.detach().cpu().numpy()
    return [np.asarray(x) for x in batch]


def _rescale_pred(pred_flow: np.ndarray, out_hw) -> np.ndarray:
    """Scale flow values and resample to the ground truth's size."""
    hh, ww = out_hw
    h, w = pred_flow.shape[:2]
    pred = pred_flow.copy()
    pred[:, :, 0] *= ww / w
    pred[:, :, 1] *= hh / h
    return resize_bilinear_np(pred, out_hw)


def evaluate_flow(gt_flows, pred_flows) -> list:
    """``[mean EPE]`` over the samples, as Python floats; with KITTI masks
    (4-channel ground truth: flow, occ mask, noc mask) ``[EPE, E_noc,
    E_occ, F1_all]``.
    gt (H,W,2|4) and pred (h,w,2+) per sample, NHWC."""

    def error_rate(epe_map, gt_flow, mask):
        bad = np.logical_and(
            epe_map * mask > 3,
            epe_map * mask
            / np.maximum(np.sqrt(np.sum(np.square(gt_flow), axis=2)), 1e-10)
            > 0.05,
        )
        return bad.sum() / max(mask.sum(), 1e-10) * 100.0

    gt_flows, pred_flows = _samples(gt_flows), _samples(pred_flows)
    error = error_noc = error_occ = f1 = 0.0
    b = len(gt_flows)
    with_masks = gt_flows[0].shape[-1] == 4
    for gt, pred in zip(gt_flows, pred_flows):
        pred = _rescale_pred(pred[:, :, :2], gt.shape[:2])
        epe_map = np.sqrt(np.sum(np.square(pred - gt[:, :, :2]), axis=2))
        if not with_masks:
            error += np.mean(epe_map)
        else:
            occ_mask = gt[:, :, 2]
            noc_mask = gt[:, :, 3]
            error += np.sum(epe_map * occ_mask) / max(np.sum(occ_mask), 1.0)
            error_noc += np.sum(epe_map * noc_mask) / max(np.sum(noc_mask), 1.0)
            error_occ += np.sum(epe_map * (occ_mask - noc_mask)) / max(
                np.sum(occ_mask - noc_mask), 1.0)
            f1 += error_rate(epe_map, gt[:, :, :2], occ_mask)
    out = [error, error_noc, error_occ, f1] if with_masks else [error]
    return [float(e / b) for e in out]


def sp_plot(error, entropy, gt_mask, n: int = 25, alpha: float = 100.0,
            eps: float = 1e-1):
    """Soft-threshold sparsification plot: the mean error over the pixels
    kept as the entropy threshold falls, at n kept fractions from 1 to 0."""
    from scipy.special import expit

    def sp_mask(thr):
        mask = expit(alpha * (thr[:, None, None] - entropy[None, :, :]))
        frac = np.sum((1.0 - mask) * gt_mask[None], axis=(1, 2)) / np.sum(gt_mask)
        return mask * gt_mask[None], frac

    greatest = np.max(entropy) + eps
    least = np.min(entropy) - eps
    _, frac = sp_mask(np.array([least]))
    while abs(frac.item() - 1.0) > eps:
        least -= 1e-3 * (greatest - least)
        _, frac = sp_mask(np.array([least]))
    _, frac = sp_mask(np.array([greatest]))
    while abs(frac.item() - 0.0) > eps:
        greatest += 1e-3 * (greatest - least)
        _, frac = sp_mask(np.array([greatest]))

    grid_entr = np.linspace(greatest, least, n)
    grid_frac = np.linspace(0, 1, n)
    mask, frac = sp_mask(grid_entr)
    for _ in range(10):
        if np.max(np.abs(frac - grid_frac)) <= eps:
            break
        grid_entr = np.interp(grid_frac, frac, grid_entr)
        mask, frac = sp_mask(grid_entr)
    if np.max(np.abs(frac - grid_frac)) > eps:
        print("Warning! sp_plot did not converge!")

    splot = np.sum(error[None, :, :] * mask, axis=(1, 2)) / np.sum(mask, axis=(1, 2))
    return np.interp(grid_frac, frac, splot)


def evaluate_uncertainty(gt_flows, pred_flows, pred_entropies,
                         sp_samples: int = 25):
    """``[AUC, AUC - oracle AUC]`` of the sparsification plots, the plots
    and the oracle's. Entropies are per-pixel (u, v) log-std maps; resizing
    one to the ground truth's size adds the log-resolution terms."""
    auc, oracle_auc = 0.0, 0.0
    splots, oracle_splots = [], []
    gt_flows, pred_flows = _samples(gt_flows), _samples(pred_flows)
    pred_entropies = _samples(pred_entropies)
    b = len(gt_flows)
    for gt, pred, ent in zip(gt_flows, pred_flows, pred_entropies):
        hh, ww = gt.shape[:2]
        h, w = pred.shape[:2]
        pred = _rescale_pred(pred[:, :, :2], (hh, ww))
        ent = ent.copy()
        ent[:, :, 0] += -2 * math.log(w) + 2 * math.log(ww)
        ent[:, :, 1] += -2 * math.log(h) + 2 * math.log(hh)
        ent = resize_bilinear_np(ent, (hh, ww))

        epe_map = np.sqrt(np.sum(np.square(pred - gt[:, :, :2]), axis=2))
        mask = gt[:, :, 2] if gt.shape[2] >= 4 else np.ones_like(epe_map)
        entropy_map = np.sum(ent[:, :, :2], axis=2)
        splot = sp_plot(epe_map, entropy_map, mask, n=sp_samples)
        oracle = sp_plot(epe_map, epe_map, mask, n=sp_samples)
        splots.append(splot)
        oracle_splots.append(oracle)
        frac = np.linspace(0, 1, sp_samples)
        auc += np.trapezoid(splot / splot[0], x=frac)
        oracle_auc += np.trapezoid(oracle / oracle[0], x=frac)
    return [auc / b, (auc - oracle_auc) / b], splots, oracle_splots


class CalibrationCurve:
    """Binned |error| against the predicted sigma."""

    def __init__(self, cc_max: float = 3.5, cc_samples: int = 100):
        self.cc_max = cc_max
        self.cc_samples = cc_samples
        self.errors = defaultdict(list)
        self.bins = np.linspace(0, cc_max, cc_samples)

    def __call__(self, gt_flows, pred_flows, pred_entropies):
        for gt, pred, ent in zip(_samples(gt_flows), _samples(pred_flows),
                                 _samples(pred_entropies)):
            sigma = np.exp(ent)
            bin_idx = np.digitize(sigma, self.bins)
            pred = _rescale_pred(pred[:, :, :2], gt.shape[:2])
            error = np.abs(pred - gt[:, :, :2])
            for idx in range(self.cc_samples + 1):
                self.errors[idx].extend(error[bin_idx == idx].reshape(-1))

    def calibration_curve(self):
        vals, means, sigmas, numbers = [], [], [], []
        for idx in range(self.cc_samples + 1):
            numbers.append(len(self.errors[idx]))
            vals.append((idx + 0.5) * self.cc_max / (self.cc_samples - 1))
            if self.errors[idx]:
                means.append(float(np.mean(self.errors[idx])))
                sigmas.append(float(np.std(self.errors[idx])))
            else:
                means.append(float("nan"))
                sigmas.append(float("nan"))
        return vals, means, sigmas, numbers
