"""Supervised MSE trainer (port of ``arflow_tpu/training/mse_trainer.py``):
the probabilistic posterior regressed to the ground-truth flow.

A step runs the model on (img1, img2) in the forward direction only
(``with_bk=False, train=True``) and ``MseLoss`` against the batch's
``target.flow``; the level dropout draws from the trainer's generator
first, then the loss's noise. The meters are ``Loss``, ``l_mse``,
``entropy`` and ``l_offdiag``. Validation is ``UFlowTrainer``'s: EPE of
``flows_fw[0]``'s flow channels on each validation loader, the checkpoint
saved under the name ``Chairs``, the best one on the EPE; its images are
the last batch's ground truth and prediction (``Valid/gt_{i}``,
``Valid/pred_{i}``), as the JAX trainer writes them.

``photometric_aug.device`` is refused (``NO_DEVICE_PHOTOMETRIC``).
"""

from __future__ import annotations

import numpy as np
import torch

from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer
from arflow_tpu_torch.utils.viz import batch_flow2rgb

METRIC_KEYS = ("total", "l_mse", "entropy", "l_offdiag")


class MseTrainer(UFlowTrainer):
    KEY_METERS = ["Loss", "l_mse", "entropy", "l_offdiag"]
    NO_DEVICE_PHOTOMETRIC = (
        "photometric_aug.device is refused by the mse trainer: the JAX "
        "package's has no _device_photometric (its step feeds the plain "
        "pair, arflow_tpu/training/mse_trainer.py:97-133) and its "
        "get_dataset drops the host augmentation for device: true "
        "(arflow_tpu/data/get_dataset.py:41-45), so there it trains with no "
        "photometric augmentation at all; ROADMAP.md queue 3")

    def _batch_inputs(self, data) -> list:
        return [self._to_device(data["img1"]), self._to_device(data["img2"]),
                self._to_device(data["target"]["flow"][..., 0:2])]

    def train_step(self, img1, img2, gt_flow) -> torch.Tensor:
        """One optimizer step on device tensors (NHWC). Returns the step's
        ``METRIC_KEYS`` as one detached device tensor."""
        out = self._step(
            lambda gen: self.model(img1, img2, with_bk=False, train=True,
                                   generator=gen),
            lambda res: self.loss_func(res, gt_flow, generator=self.generator))
        return torch.stack([out[k].detach() for k in METRIC_KEYS])

    def _valid_images(self, i_set, data, img1, img2, pred):
        gt = np.asarray(data["target"]["flow"])[..., :2]
        self._images(f"Valid/gt_{i_set}", batch_flow2rgb(gt))
        self._images(f"Valid/pred_{i_set}",
                     batch_flow2rgb(pred.float().cpu().numpy()))
