"""UFlow trainer (port of ``arflow_tpu/training/uflow_trainer.py``): the
model predicts on the photometrically augmented ``img{1,2}_ph`` (the plain
images where a batch has none), the loss compares against the originals.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.training.trainer import BaseTrainer, Timer, not_ported
from arflow_tpu_torch.utils.meters import AverageMeter
from arflow_tpu_torch.utils.metrics import evaluate_flow

METRIC_KEYS = ("total", "l_ph", "l_sm", "flow_mean")


def device_photometric_cfg(full_cfg):
    """The ``photometric_aug`` flagged ``device: true`` in the config's
    train data entries, or None."""
    for entry in (full_cfg or {}).get("data", []):
        ph = entry.get("photometric_aug")
        if entry.get("type") == "train" and ph and ph.get("device"):
            return ph
    return None


class UFlowTrainer(BaseTrainer):
    KEY_METERS = ["Loss", "l_ph", "l_sm", "flow_mean"]

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if device_photometric_cfg(self.full_cfg) is not None:
            raise not_ported("device-side photometric augmentation",
                             "queue 1, 'device-side augmentation'")

    def _batch_inputs(self, data) -> list:
        """A loader batch -> ``train_step``'s device tensors."""
        img1, img2 = (self._to_device(data[k]) for k in ("img1", "img2"))
        img1_ph = self._to_device(data["img1_ph"]) if "img1_ph" in data else img1
        img2_ph = self._to_device(data["img2_ph"]) if "img2_ph" in data else img2
        return [img1, img2, img1_ph, img2_ph]

    def train_step(self, img1, img2, img1_ph, img2_ph) -> torch.Tensor:
        """One optimizer step on device tensors (NHWC). Returns the step's
        ``METRIC_KEYS`` as one detached device tensor."""
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
        """Mean EPE of ``flows_fw[0]`` on each validation loader; with
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
            for i_step, data in enumerate(loader):
                img1, img2 = (self._to_device(data[k]) for k in ("img1", "img2"))
                pred = self.model(img1, img2, with_bk=False)["flows_fw"][0]
                es = evaluate_flow(data["target"]["flow"], pred)
                error_meters.update(es, img1.shape[0])
                if i_step % self.cfg.print_freq == 0 or i_step == len(loader) - 1:
                    self._log.info(
                        "Test: %d[%d/%d] %s", i_set, i_step, self.cfg.valid_size,
                        " ".join(f"{a:.2f}" for a in error_meters.avg),
                    )
                if i_step > self.cfg.valid_size:
                    break

            for value, name in zip(error_meters.avg, error_names):
                self._summary(f"Valid_{name}_{i_set}", value, self.i_epoch)
            all_error_avgs.extend(error_meters.avg)
            all_error_names.extend(f"{n}_{i_set}" for n in error_names)

        if self.i_iter > self.cfg.get("save_iter", 0):
            self.save_model(all_error_avgs[0], name="Chairs")
        return all_error_avgs, all_error_names
