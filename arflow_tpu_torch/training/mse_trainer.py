"""Supervised MSE trainer (port of ``arflow_tpu/training/mse_trainer.py``):
the probabilistic posterior regressed to the ground-truth flow.

A step runs the model on (img1, img2) in the forward direction only
(``with_bk=False, train=True``) and ``MseLoss`` against the batch's
``target.flow``; the level dropout draws from the trainer's generator
first, then the loss's noise. The meters are ``Loss``, ``l_mse``,
``entropy`` and ``l_offdiag``. Validation is ``UFlowTrainer``'s: EPE of
``flows_fw[0]``'s flow channels on each validation loader, the checkpoint
saved under the name ``Chairs``, the best one on the EPE.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer

METRIC_KEYS = ("total", "l_mse", "entropy", "l_offdiag")


class MseTrainer(UFlowTrainer):
    KEY_METERS = ["Loss", "l_mse", "entropy", "l_offdiag"]

    def _batch_inputs(self, data) -> list:
        return [self._to_device(data["img1"]), self._to_device(data["img2"]),
                self._to_device(data["target"]["flow"][..., 0:2])]

    def train_step(self, img1, img2, gt_flow) -> torch.Tensor:
        """One optimizer step on device tensors (NHWC). Returns the step's
        ``METRIC_KEYS`` as one detached device tensor."""
        res = self.model(img1, img2, with_bk=False, train=True,
                         generator=self.generator)
        out = self.loss_func(res, gt_flow, generator=self.generator)
        self.optimizer.zero_grad()
        out["total"].backward()
        self.optimizer.step()
        return torch.stack([out[k].detach() for k in METRIC_KEYS])
