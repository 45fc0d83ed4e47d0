"""UFlow trainer (port of ``arflow_tpu/training/uflow_trainer.py``): the
model predicts on the photometrically augmented ``img{1,2}_ph`` (the plain
images where a batch has none), the loss compares against the originals.
It trains the ``uflow`` model with ``UFlowLoss`` and the PWC-Lite family
with the ``unflow`` and ``fullres`` losses.

With ``"device": true`` in a train entry's ``photometric_aug`` the loader
emits no ``_ph`` copies and the step augments on the card
(``data/device_aug.py``): the pair is stacked to (B, 2, H, W, 3) in
float32, one parameter set is drawn per sample from the trainer's
augmentation generator (``aug_generator``, seeded from the config's seed
apart from the level-dropout generator, saved in checkpoints beside it),
and the augmented pair, cast to the model's dtype, feeds the model. The
ELBO and MSE trainers refuse ``device: true`` (``NO_DEVICE_PHOTOMETRIC``).

Validation writes the last batch's ground truth and prediction as images
(``Valid/gt``, ``Valid/pred_{i}``) and the loss's occlusion mask
(``Valid/mask_{i}``) where the loss returns one (``uflow``; not
``unflow`` or ``fullres``, where the JAX trainer raises).

The ``elbo`` loss (``ElboLoss``) has no trainer, in the JAX package
either, and this trainer and the ELBO trainer refuse it when they are
built (``ELBO_HAS_NO_TRAINER``).
"""

from __future__ import annotations

import numpy as np
import torch

from arflow_tpu_torch.data.device_aug import (
    device_photometric_cfg,
    make_photometric,
)
from arflow_tpu_torch.losses import ElboLoss, UFlowLoss
from arflow_tpu_torch.training.trainer import BaseTrainer, Timer
from arflow_tpu_torch.utils.meters import AverageMeter
from arflow_tpu_torch.utils.metrics import evaluate_flow
from arflow_tpu_torch.utils.viz import batch_flow2rgb

METRIC_KEYS = ("total", "l_ph", "l_sm", "flow_mean")
ELBO_HAS_NO_TRAINER = (
    "loss type 'elbo' has no trainer, in the JAX package either: its uflow "
    "trainer calls the loss without the noise that it needs "
    "(arflow_tpu/losses/elbo.py:38-40), and its uflow_elbo trainer reads an "
    "'l_oof' term that the loss does not return "
    "(arflow_tpu/training/uflow_elbo_trainer.py:93-104)")


class UFlowTrainer(BaseTrainer):
    KEY_METERS = ["Loss", "l_ph", "l_sm", "flow_mean"]
    # Why a subclass refuses photometric_aug.device (None: it augments).
    NO_DEVICE_PHOTOMETRIC = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if isinstance(self.loss_func, ElboLoss):
            raise ValueError(ELBO_HAS_NO_TRAINER)
        ph_cfg = device_photometric_cfg(self.full_cfg)
        if ph_cfg is not None and self.NO_DEVICE_PHOTOMETRIC:
            raise NotImplementedError(self.NO_DEVICE_PHOTOMETRIC)
        self.device_photometric = make_photometric(ph_cfg) if ph_cfg else None

    def _batch_inputs(self, data) -> list:
        """A loader batch -> ``train_step``'s device tensors: the pair in
        float32 where the step augments it, else the pair and its ``_ph``
        copies (the pair where the batch has none) in the model's dtype."""
        if self.device_photometric is not None:
            return [torch.as_tensor(data[k], dtype=torch.float32,
                                    device=self.device) for k in ("img1", "img2")]
        img1, img2 = (self._to_device(data[k]) for k in ("img1", "img2"))
        img1_ph = self._to_device(data["img1_ph"]) if "img1_ph" in data else img1
        img2_ph = self._to_device(data["img2_ph"]) if "img2_ph" in data else img2
        return [img1, img2, img1_ph, img2_ph]

    def augment(self, img1, img2):
        """The pair augmented on its device: one parameter set per sample
        from ``aug_generator``, shared by the two frames. float32."""
        sample_params, apply = self.device_photometric
        params = sample_params(self.aug_generator, img1.shape[0], img1.device)
        ph = apply(torch.stack([img1, img2], dim=1), params)
        return ph[:, 0], ph[:, 1]

    def train_step(self, img1, img2, img1_ph=None, img2_ph=None) -> torch.Tensor:
        """One optimizer step on device tensors (NHWC); without ``_ph``
        images, augmented here where the config asks for it. Returns the
        step's ``METRIC_KEYS`` as one detached device tensor."""
        if img1_ph is None:
            img1_ph, img2_ph = (self.augment(img1, img2)
                                if self.device_photometric is not None
                                else (img1, img2))
        img1, img2, img1_ph, img2_ph = (
            x.to(self.dtype) for x in (img1, img2, img1_ph, img2_ph))
        out = self._step(
            lambda gen: self.model(img1_ph, img2_ph, with_bk=True, train=True,
                                   generator=gen),
            lambda res: self.loss_func(res, img1, img2))
        return torch.stack([out[k].detach() for k in METRIC_KEYS])

    def _run_one_epoch(self):
        am_batch_time = AverageMeter()
        am_data_time = AverageMeter()
        key_meters = AverageMeter(i=len(self.KEY_METERS), precision=4)
        timer = Timer()

        self._begin_epoch()
        for i_step, data in enumerate(self.train_loader):
            if i_step > self.cfg.epoch_size:
                break
            self._ensure_init()
            inputs = self._batch_inputs(data)
            am_data_time.update(timer.lap())
            metrics = self.train_step(*inputs)
            am_batch_time.update(timer.lap())
            self._queue_step_metrics(metrics, inputs[0].shape[0], i_step,
                                     key_meters, self.KEY_METERS,
                                     am_batch_time, am_data_time)
            self.i_iter += 1
        self._flush_metrics(key_meters, self.KEY_METERS, am_batch_time,
                            am_data_time)
        self.i_epoch += 1

    @torch.no_grad()
    def _validate_with_gt(self):
        """Mean EPE of ``flows_fw[0]``'s flow channels on each validation
        loader; with
        ``valid_masks`` (KITTI's 4-channel ground truth) also E_noc, E_occ
        and F1_all."""
        loaders = self.valid_loader
        if not isinstance(loaders, list):
            loaders = [loaders]

        all_error_avgs = []
        all_error_names = []
        for i_set, loader in enumerate(loaders):
            error_names = ["EPE"]
            if self.cfg.get("valid_masks"):
                error_names += ["E_noc", "E_occ", "F1_all"]
            error_meters = AverageMeter(i=len(error_names))
            last = None
            for i_step, data in enumerate(loader):
                img1, img2 = (self._to_device(data[k]) for k in ("img1", "img2"))
                pred = self.model(img1, img2, with_bk=False)["flows_fw"][0][..., 0:2]
                es = evaluate_flow(data["target"]["flow"], pred)
                error_meters.update(es, img1.shape[0])
                last = (data, img1, img2, pred)
                if i_step % self.cfg.print_freq == 0 or i_step == len(loader) - 1:
                    self._log.info(
                        "Test: %d[%d/%d] %s", i_set, i_step, self.cfg.valid_size,
                        " ".join(f"{a:.2f}" for a in error_meters.avg),
                    )
                if i_step > self.cfg.valid_size:
                    break

            for value, name in zip(error_meters.avg, error_names):
                self._summary(f"Valid_{name}_{i_set}", value, self.i_epoch)
            if last is not None:
                self._valid_images(i_set, *last)
            all_error_avgs.extend(error_meters.avg)
            all_error_names.extend(f"{n}_{i_set}" for n in error_names)

        if self.i_iter > self.cfg.get("save_iter", 0):
            self.save_model(all_error_avgs[0], name="Chairs")
        return all_error_avgs, all_error_names

    def _valid_images(self, i_set, data, img1, img2, pred):
        """The last validation batch's ground truth, prediction and, where
        the loss returns one, occlusion mask, tagged as the JAX trainer
        tags them."""
        gt = np.asarray(data["target"]["flow"])[..., :2]
        self._images("Valid/gt", batch_flow2rgb(gt))
        self._images(f"Valid/pred_{i_set}",
                     batch_flow2rgb(pred.float().cpu().numpy()))
        # UFlowLoss is the loss that returns mask1 (unflow and fullres
        # return none): one forward in both directions of this batch.
        if isinstance(self.loss_func, UFlowLoss):
            out = self.loss_func(self.model(img1, img2, with_bk=True), img1, img2)
            self._images(f"Valid/mask_{i_set}", out["mask1"].float().cpu().numpy())
