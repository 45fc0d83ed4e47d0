"""ELBO trainer (port of ``arflow_tpu/training/uflow_elbo_trainer.py``):
the ``uflow`` trainer's loop around ``UFlowElboLoss``.

The model predicts on the plain ``img1`` / ``img2`` (not the ``_ph``
copies) with ``with_bk=True, train=True``, and the loss samples its
posterior. Both draw from the trainer's one generator, the one a
checkpoint saves: the level dropout first, then the loss's noise. So a
resumed run without augmentation continues the unbroken one bit for bit.
``cfg.clip`` clips in the optimizer.

Validation runs the model without dropout and the loss with noise from a
generator seeded ``cfg.seed`` anew at each validation, so that the
validation losses of two epochs see the same draws. It records ``Loss``,
``l_ph``, ``l_sm``, ``entropy``, ``l_oof`` and ``EPE`` (with
``valid_masks`` also ``E_noc``, ``E_occ``, ``F1_all``; with ``track_auc``
``AUC`` and ``AUC_diff`` from ``evaluate_uncertainty`` on
``extract_uv_entropy``), feeds a ``CalibrationCurve`` with ``track_cc``,
writes the last batch's level-2 outputs as ``flow_fw_l2_{epoch}.npy``,
and saves the checkpoint, the best one chosen on the validation ``Loss``.
The sparsification and calibration plots are written as PNG files where
matplotlib imports, with a warning where it does not; the port writes no
image summaries.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from arflow_tpu_torch.training.entropy import extract_uv_entropy
from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer
from arflow_tpu_torch.utils.meters import AverageMeter
from arflow_tpu_torch.utils.metrics import (
    CalibrationCurve,
    evaluate_flow,
    evaluate_uncertainty,
)

METRIC_KEYS = ("total", "l_ph", "l_sm", "entropy", "l_oof")


class UFlowElboTrainer(UFlowTrainer):
    KEY_METERS = ["Loss", "l_ph", "l_sm", "entropy", "l_oof"]

    def _batch_inputs(self, data) -> list:
        return [self._to_device(data[k]) for k in ("img1", "img2")]

    def train_step(self, img1, img2) -> torch.Tensor:
        """One optimizer step on device tensors (NHWC). Returns the step's
        ``METRIC_KEYS`` as one detached device tensor."""
        res = self.model(img1, img2, with_bk=True, train=True,
                         generator=self.generator)
        out = self.loss_func(res, img1, img2, generator=self.generator)
        self.optimizer.zero_grad()
        out["total"].backward()
        self.optimizer.step()
        return torch.stack([out[k].detach() for k in METRIC_KEYS])

    @torch.no_grad()
    def _validate_with_gt(self):
        loaders = self.valid_loader
        if not isinstance(loaders, list):
            loaders = [loaders]
        track_auc = bool(self.cfg.get("track_auc"))
        cc = CalibrationCurve() if self.cfg.get("track_cc") else None
        sp_samples = self.cfg.get("sp_samples", 25)
        loss_cfg = self.loss_func.cfg
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.get("seed", 0))

        all_error_avgs = []
        all_error_names = []
        for i_set, loader in enumerate(loaders):
            error_names = ["Loss", "l_ph", "l_sm", "entropy", "l_oof", "EPE"]
            if self.cfg.get("valid_masks"):
                error_names += ["E_noc", "E_occ", "F1_all"]
            if track_auc:
                error_names += ["AUC", "AUC_diff"]
            error_meters = AverageMeter(i=len(error_names))
            splots, oplots = [], []
            flows_l2 = None
            for i_step, data in enumerate(loader):
                img1, img2 = (self._to_device(data[k]) for k in ("img1", "img2"))
                res = self.model(img1, img2, with_bk=True)
                out = self.loss_func(res, img1, img2, generator=generator)
                flows = res["flows_fw"]
                entropy = extract_uv_entropy(flows, loss_cfg, res,
                                             generator=generator)
                gt = np.asarray(data["target"]["flow"])
                pred = flows[0][..., 0:2].cpu().numpy()
                ent = entropy.cpu().numpy()
                error_values = torch.stack(
                    [out[k] for k in METRIC_KEYS]).cpu().tolist()
                error_values += evaluate_flow(gt, pred)
                if cc is not None:
                    cc(gt, pred, ent)
                if track_auc:
                    auc, splot, oplot = evaluate_uncertainty(
                        gt, pred, ent, sp_samples=sp_samples)
                    splots += splot
                    oplots += oplot
                    error_values += [float(a) for a in auc]
                error_meters.update(error_values, img1.shape[0])
                flows_l2 = flows[2]
                if i_step % self.cfg.print_freq == 0 or i_step == len(loader) - 1:
                    self._log.info(
                        "Test: %d[%d/%d] %s", i_set, i_step, self.cfg.valid_size,
                        " ".join(f"{a:.2f}" for a in error_meters.avg),
                    )
                if i_step > self.cfg.valid_size:
                    break

            for value, name in zip(error_meters.avg, error_names):
                self._summary(f"Valid_{name}_{i_set}", value, self.i_epoch)
            if flows_l2 is not None:
                os.makedirs(self.save_root, exist_ok=True)
                np.save(os.path.join(self.save_root,
                                     f"flow_fw_l2_{self.i_epoch}.npy"),
                        flows_l2.cpu().numpy())
            if splots:
                self._plot_splots(splots, oplots, sp_samples, i_set)
            all_error_avgs.extend(error_meters.avg)
            all_error_names.extend(f"{n}_{i_set}" for n in error_names)

        if cc is not None:
            self._plot_calibration(cc)
        if self.i_iter > self.cfg.get("save_iter", 0):
            self.save_model(all_error_avgs[0], name="Chairs")
        return all_error_avgs, all_error_names

    def _plot_splots(self, splots, oplots, sp_samples, i_set):
        """The mean sparsification plot and the oracle's, as
        ``splot_{i_set}_{epoch}.png``."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            x = np.linspace(0, 1, sp_samples)
            fig, ax = plt.subplots()
            ax.plot(x, np.mean(splots, axis=0))
            ax.plot(x, np.mean(oplots, axis=0))
            ax.legend(["splot", "oracle"])
            fig.savefig(os.path.join(self.save_root,
                                     f"splot_{i_set}_{self.i_epoch}.png"))
            plt.close(fig)
        except Exception as e:
            self._log.warning("splot rendering failed: %s", e)

    def _plot_calibration(self, cc):
        """The calibration curve, as ``calibration_{epoch}.png``."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            vals, means, sigmas, numbers = cc.calibration_curve()
            fig, ax = plt.subplots(1, 2, figsize=(30, 10))
            ax[0].errorbar(vals, means, sigmas, fmt="o", linewidth=2, capsize=6)
            ax[0].set_xlabel("sigma")
            ax[0].set_ylabel("epe")
            ax[0].grid()
            ax[1].stem(vals, numbers)
            ax[1].set_yscale("log")
            fig.savefig(os.path.join(self.save_root,
                                     f"calibration_{self.i_epoch}.png"))
            plt.close(fig)
        except Exception as e:
            self._log.warning("calibration rendering failed: %s", e)
