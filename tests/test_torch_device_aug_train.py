"""``photometric_aug.device`` through the port's ``UFlowTrainer`` on the CPU
at 64x96 b2 (the JAX package's ``tests/test_training_e2e.py`` holds its
own): a step that augments on its device equals, bit for bit, the same
step fed ``apply``'s images as ``img*_ph``; a resume restores both
generators and continues the unbroken run bit for bit; the ELBO and MSE
trainers refuse the flag and say why.
"""

import logging

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.data.device_aug import make_photometric
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.checkpoint import load_checkpoint
from arflow_tpu_torch.training.mse_trainer import MseTrainer
from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer
from torch_port_util import H, W, few_torch_threads  # noqa: F401  (fixture)

B = 2
TRAIN = {"batch_size": B, "epoch_num": 1, "epoch_size": 1000, "valid_size": 0,
         "valid_freq": 10**9, "optim": "adam", "lr": 1e-4, "beta1": 0.9,
         "beta2": 0.999, "weight_decay": 0.0, "bias_decay": 0.0,
         "lr_decay_start_epoch": 300, "lr_decay_factor": 0.98,
         "print_freq": 1, "record_freq": 1, "save_iter": 10**9, "seed": 3}
MODEL = {"type": "uflow", "feature_norm": True, "level_dropout": 0.5}
LOSS = {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0, "smooth_order": 1,
        "edge_constant": 150.0, "with_bk": True}
PH = {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3, "hue": 0.5,
      "gamma": 1, "swap_channels": True, "device": True}
log = logging.getLogger("test")


def _batch(seed):
    rs = np.random.RandomState(seed)
    img1 = rs.rand(B, H, W, 3).astype(np.float32)
    img2 = np.roll(img1, (1, 2), axis=(1, 2)) * 0.9 + 0.05
    return {"img1": img1, "img2": img2.astype(np.float32)}


def _trainer(tmp_path, name="uflow", device_aug=True, **train):
    full = {"model": MODEL, "loss": LOSS, "train": dict(TRAIN, **train)}
    if device_aug:
        full["data"] = [{"type": "train", "name": "Chairs",
                         "photometric_aug": PH}]
    full = Config(full)
    model = get_model(full.model, device="cpu")
    return get_trainer(name)([_batch(0)], None, model, get_loss(full.loss),
                             log, str(tmp_path), full.train,
                             model_cfg=full.model, full_cfg=full)


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


def test_device_step_equals_step_fed_apply_images(tmp_path):
    """Trainer A augments in its step; trainer B, the same weights and
    dropout generator, is fed ``apply`` of the params drawn from A's
    augmentation generator's state: the same metrics and parameters, bit
    for bit, and A's loss sees the un-augmented pair."""
    a = _trainer(tmp_path / "a")
    b = _trainer(tmp_path / "b", device_aug=False)
    for t in (a, b):
        t._ensure_init()
    assert b.aug_generator is None and a.aug_generator is not None
    for step in range(2):
        batch = _batch(10 + step)
        inputs = a._batch_inputs(batch)
        assert len(inputs) == 2 and inputs[0].dtype == torch.float32
        gen = torch.Generator().set_state(a.aug_generator.get_state())
        sample_params, apply = make_photometric(PH)
        img1, img2 = (torch.from_numpy(batch[k]) for k in ("img1", "img2"))
        ph = apply(torch.stack([img1, img2], 1), sample_params(gen, B, "cpu"))
        assert not torch.equal(ph[:, 0], img1)
        got = a.train_step(*inputs)
        want = b.train_step(img1, img2, ph[:, 0], ph[:, 1])
        assert torch.equal(got, want)
        assert torch.equal(a.aug_generator.get_state(), gen.get_state())
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for p, q in zip(_params(a), _params(b)):
        assert torch.equal(p, q)


def test_resume_restores_both_generators(tmp_path):
    """Two steps, a checkpoint, two more; a trainer resumed from the
    checkpoint takes the last two to the same parameters, optimizer
    moments and generator states, bit for bit."""
    batches = [_batch(20 + i) for i in range(4)]
    run = _trainer(tmp_path / "run")
    run._ensure_init()
    for batch in batches[:2]:
        run.train_step(*run._batch_inputs(batch))
    run.save_model(1.0, name="Chairs")
    ckpt = load_checkpoint(str(tmp_path / "run" / "Chairs_ckpt.pth.tar"))
    assert torch.equal(ckpt["aug_generator"], run.aug_generator.get_state())
    assert not torch.equal(ckpt["aug_generator"], ckpt["generator"])
    for batch in batches[2:]:
        run.train_step(*run._batch_inputs(batch))

    resumed = _trainer(tmp_path / "resumed")
    resumed._resume_ckpt = ckpt
    resumed._ensure_init()
    for batch in batches[2:]:
        resumed.train_step(*resumed._batch_inputs(batch))
    for p, q in zip(_params(run), _params(resumed)):
        assert torch.equal(p, q)
    for gen in ("generator", "aug_generator"):
        assert torch.equal(getattr(run, gen).get_state(),
                           getattr(resumed, gen).get_state())
    opt_a, opt_b = (t.optimizer.optimizer.state_dict()["state"]
                    for t in (run, resumed))
    for k in opt_a:
        for name in opt_a[k]:
            assert torch.equal(opt_a[k][name], opt_b[k][name])


def test_train_without_device_aug_saves_no_aug_generator(tmp_path):
    t = _trainer(tmp_path, device_aug=False)
    t._ensure_init()
    t.train_step(*t._batch_inputs(_batch(1)))
    t.save_model(1.0, name="Chairs")
    assert "aug_generator" not in load_checkpoint(
        str(tmp_path / "Chairs_ckpt.pth.tar"))


@pytest.mark.parametrize("name,cls", [("uflow_elbo", UFlowElboTrainer),
                                      ("mse", MseTrainer)])
def test_elbo_and_mse_trainers_refuse_device_aug(tmp_path, name, cls):
    with pytest.raises(NotImplementedError) as err:
        _trainer(tmp_path, name=name)
    assert str(err.value) == cls.NO_DEVICE_PHOTOMETRIC
    for words in ("no _device_photometric", "no photometric augmentation",
                  "ROADMAP.md queue 3"):
        assert words in str(err.value)
    _trainer(tmp_path, name=name, device_aug=False)  # without it, built
