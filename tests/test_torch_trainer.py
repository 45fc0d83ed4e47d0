"""The port's ``UFlowTrainer`` on its own, on the CPU at a small size: the
deferred NaN guard, pretrained weights, validation EPE and the step's
launch-free CPU path. The lockstep against the JAX trainer is in
``test_torch_trainer_lockstep.py``."""

import logging

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.ops.cuda import KERNELS
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.utils.metrics import evaluate_flow
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

B, H, W = 1, 64, 96
CFG = {
    "loss": {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0,
             "smooth_order": 1, "edge_constant": 150.0, "with_bk": True},
    "model": {"type": "uflow", "feature_norm": True, "level_dropout": 0.1},
    "train": {"batch_size": B, "epoch_num": 1, "epoch_size": 1000,
              "valid_size": 0, "valid_freq": 1, "optim": "adam", "lr": 1e-4,
              "beta1": 0.9, "beta2": 0.999, "eps": 1e-8, "weight_decay": 0.0,
              "bias_decay": 0.0, "lr_decay_start_epoch": 300,
              "lr_decay_factor": 0.98, "print_freq": 100, "record_freq": 100,
              "save_iter": 100, "clip": -1.0, "seed": 0},
}


def _batch(rs, flow=False):
    b = {"img1": rs.rand(B, H, W, 3).astype(np.float32),
         "img2": rs.rand(B, H, W, 3).astype(np.float32)}
    if flow:
        b["target"] = {"flow": rs.randn(B, H, W, 2).astype(np.float32)}
    return b


def _trainer(save_root, train, valid=None, **overrides):
    cfg = Config(CFG)
    cfg.train.update(overrides)
    model = get_model(cfg.model, device="cpu")
    return get_trainer("uflow")(train, valid, model, get_loss(cfg.loss),
                                logging.getLogger("test"), str(save_root),
                                cfg.train, model_cfg=cfg.model, full_cfg=cfg)


class _NanAt:
    """A loss whose total turns NaN at one call."""

    def __init__(self, loss, at):
        self.loss, self.at, self.calls = loss, at, 0

    def __call__(self, *args):
        out = self.loss(*args)
        if self.calls == self.at:
            out["total"] = out["total"] * float("nan")
        self.calls += 1
        return out


def test_nan_guard_names_the_iteration(tmp_path):
    rs = np.random.RandomState(0)
    tr = _trainer(tmp_path, [_batch(rs) for _ in range(3)])
    tr.loss_func = _NanAt(tr.loss_func, at=1)
    with pytest.raises(FloatingPointError, match="at iter 1 "):
        tr.train()
    assert tr.i_iter == 3  # the rows were deferred to the epoch's flush


def test_pretrained_weights_and_cpu_path_launch_nothing(tmp_path):
    rs = np.random.RandomState(1)
    source = get_model(Config(CFG["model"]), device="cpu", seed=5)
    path = str(tmp_path / "w.pth.tar")
    torch.save({"epoch": 0, "state_dict": source.state_dict()}, path)
    tr = _trainer(tmp_path, [_batch(rs)], pretrained_model=path)
    before = [k.launches for k in KERNELS]
    tr._ensure_init()
    for k, v in source.state_dict().items():
        torch.testing.assert_close(tr.model.state_dict()[k], v, rtol=0, atol=0)
    tr.train()
    assert tr.i_iter == 1 and tr.optimizer.count == 1
    assert [k.launches for k in KERNELS] == before


def test_validation_epe(tmp_path):
    rs = np.random.RandomState(2)
    valid = [_batch(rs, flow=True) for _ in range(2)]
    tr = _trainer(tmp_path, [_batch(rs)], [valid], valid_size=10)
    tr.train()  # one step, then validation (no save is due at iter 1)
    errors, names = tr._validate_with_gt()
    assert names == ["EPE_0"]
    with torch.no_grad():
        want = np.mean([evaluate_flow(
            torch.from_numpy(v["target"]["flow"]),
            tr.model(torch.from_numpy(v["img1"]), torch.from_numpy(v["img2"]),
                     with_bk=False)["flows_fw"][0])[0] for v in valid])
    np.testing.assert_allclose(errors[0], want, rtol=1e-6)


def test_evaluate_flow_rescales_the_prediction():
    gt = torch.ones((1, 8, 12, 2))
    pred = torch.ones((1, 4, 6, 2)) * 0.5  # half size, half the values
    assert evaluate_flow(gt, pred) == [0.0]
    # KITTI's occlusion masks: EPE, E_noc, E_occ, F1_all over the masks
    assert evaluate_flow(torch.ones((1, 8, 12, 4)), pred) == [0.0] * 4
