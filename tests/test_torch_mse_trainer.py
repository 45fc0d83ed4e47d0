"""The port's ``MseTrainer`` (supervised training of the probabilistic
UFlow, ``configs/chairs_uflow_mse.json``):

- in lockstep with ``arflow_tpu``'s for two steps in float64 (its model
  with dropout off, its loss with the same fixed draws at each step), then
  validation: the EPE of both and the ``Chairs`` checkpoints;
- ``train_main(device="cpu")`` with the shipped config, its data roots on
  a FlyingChairs directory with ``.flo`` ground truth: six steps lower the
  loss of one fixed batch.
"""

import json
import logging
import os

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses.mse import MseLoss as JaxMseLoss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.parallel import make_mesh, replicate
from arflow_tpu.training.mse_trainer import MseTrainer as JaxMseTrainer
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu_torch import Config, cli, load_config
from arflow_tpu_torch.data import Chairs
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model, uflow_prob_state_dict_from_jax
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.mse_trainer import MseTrainer
from arflow_tpu_torch.training.checkpoint import load_checkpoint
from torch_data_util import make_shifted_chairs_dir
from torch_port_util import H, W, draw_jax_params, few_torch_threads  # noqa: F401
from torch_prob_util import GATES_OFF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow_mse.json")
B = 2
KEYS = ("total", "l_mse", "entropy", "l_offdiag")
log = logging.getLogger("test")


class _FixedNoise:
    """An MSE loss that takes the same injected draws at every call."""

    def __init__(self, loss, noise):
        self.loss, self.noise, self.cfg = loss, noise, loss.cfg

    def __call__(self, res, gt_flow, rng=None, generator=None):
        return self.loss(res, gt_flow, noise=self.noise)


def _batches(rs, n):
    """Pairs of a texture moved by a few pixels, the shift as the flow."""
    out = []
    for dy, dx in ((1, 2), (-2, 1))[:n]:
        tex = rs.rand(B, H + 8, W + 8, 3)
        flow = np.tile(np.array([dx, dy], np.float64), (B, H, W, 1))
        out.append({"img1": tex[:, 4:4 + H, 4:4 + W],
                    "img2": tex[:, 4 - dy:4 - dy + H, 4 - dx:4 - dx + W],
                    "target": {"flow": flow}})
    return out


def test_mse_trainer_lockstep_f64_and_validation(monkeypatch, tmp_path):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    with open(CONFIG) as f:
        full = json.load(f)
    model_c = dict(full["model"], level_dropout=0.0)
    loss_c = full["loss"]
    train_c = dict(full["train"], batch_size=B, epoch_num=1, epoch_size=1000,
                   lr=1e-7, weight_decay=1e-2, print_freq=100, record_freq=1,
                   save_iter=0, valid_freq=10**9, seed=0)
    rs = np.random.RandomState(31)
    batches = _batches(rs, 2)
    valid = [_batches(np.random.RandomState(32), 2)]
    noise = {"eps": rs.randn(B, H // 4, W // 4, 2)}
    params = draw_jax_params(model_c, seed=33, with_bk=True)
    params0 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), params)

    records = {"jax": [], "port": []}

    class JaxRecording(JaxMseTrainer):
        def _queue_step_metrics(self, metrics, *a, **k):
            records["jax"].append([float(metrics[key]) for key in KEYS])
            super()._queue_step_metrics(metrics, *a, **k)

    class PortRecording(MseTrainer):
        def _queue_step_metrics(self, metrics, *a, **k):
            records["port"].append(metrics.tolist())
            super()._queue_step_metrics(metrics, *a, **k)

    mesh = make_mesh(devices=np.array(jax.devices()[:1]))
    loss_j = _FixedNoise(JaxMseLoss(JaxConfig(loss_c)),
                         {"eps": jnp.asarray(noise["eps"])})
    tr_j = JaxRecording(batches, valid, jax_get_model(JaxConfig(model_c)), loss_j,
                        log, str(tmp_path / "jax"), JaxConfig(train_c),
                        model_cfg=JaxConfig(model_c), mesh=mesh)
    tr_j.tx = jax_create_optimizer(JaxConfig(train_c), params0, 2)
    tr_j.state = replicate(mesh, {"params": params0,
                                  "opt_state": tr_j.tx.init(params0),
                                  "step": jnp.zeros((), jnp.int32)})
    tr_j._train_step = tr_j._build_train_step()
    tr_j.train()
    errors_j, names_j = tr_j._validate_with_gt()

    model = get_model(Config(model_c), device="cpu")
    model.load_state_dict(uflow_prob_state_dict_from_jax(params), strict=True)
    model = model.double()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    loss_t = _FixedNoise(get_loss(Config(loss_c)),
                         {"eps": torch.from_numpy(noise["eps"])})
    tr_t = PortRecording(batches, valid, model, loss_t, log, str(tmp_path / "port"),
                         Config(train_c), model_cfg=Config(model_c))
    assert get_trainer(full["trainer"]) is get_trainer("ChairsMse") is MseTrainer
    tr_t.train()
    errors_t, names_t = tr_t._validate_with_gt()

    assert tr_t.i_iter == tr_j.i_iter == 2
    assert tr_t.KEY_METERS == ["Loss", "l_mse", "entropy", "l_offdiag"]
    # float64 losses through the same math (the JAX lockstep's own bound)
    np.testing.assert_allclose(np.array(records["port"]), np.array(records["jax"]),
                               rtol=1e-8, atol=1e-12)
    assert records["port"][0][3] > 0  # the off-diagonal penalty is on
    delta_j = uflow_prob_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b, np.float64),
        jax.device_get(tr_j.state["params"]), params))
    moved = 0
    for name, v in model.state_dict().items():
        delta_t = (v - sd0[name]).float()
        torch.testing.assert_close(delta_t, delta_j[name], rtol=0, atol=1e-10,
                                   msg=name)
        moved += int(delta_t.abs().max() > 0)
    assert moved > 90
    # validation: EPE of flows_fw[0]'s flow channels, the best checkpoint on it
    assert names_t == names_j == ["EPE_0"]
    np.testing.assert_allclose(errors_t, errors_j, rtol=1e-10)
    ckpt = load_checkpoint(str(tmp_path / "port" / "Chairs_model_best.pth.tar"))
    assert ckpt["best_error"] == tr_t.best_error == errors_t[0]
    assert (tmp_path / "port" / "Chairs_ckpt.pth.tar").is_file()


def test_train_main_chairs_uflow_mse_lowers_the_loss(tmp_path):
    """The shipped config (its data section reads the train stream's
    ``.flo``): batch 2 and the valid pairs' 64x96 instead of its 16 and
    384x512, two epochs of 3 steps that validate and save."""
    # fids 1-7: fid 6 is the valid split, 6 train pairs make 3 batches of 2
    root = make_shifted_chairs_dir(tmp_path / "chairs", np.random.RandomState(34),
                                   7, H, W)
    cfg = load_config(CONFIG)
    assert cfg.data[0].with_flow and cfg.trainer == "mse"
    for entry in cfg.data:
        entry.root_chairs = str(root)
    cfg.data[1].test_shape = [H, W]
    cfg.save_root = str(tmp_path / "run")
    cfg.train.update(batch_size=2, epoch_num=2, workers=2, print_freq=1,
                     save_iter=0)
    untrained = get_model(cfg.model, device="cpu", seed=cfg.seed)
    trainer = cli.train_main(cfg, log, device="cpu")
    assert isinstance(trainer, MseTrainer)
    assert (trainer.i_epoch, trainer.i_iter, trainer.optimizer.count) == (2, 6, 6)
    with open(tmp_path / "run" / "events.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epe = [r["value"] for r in recs if r["tag"] == "Valid_EPE_0"]
    assert len(epe) == 2 and np.isfinite(epe).all()  # val_epoch_size 1
    assert len([r for r in recs if r["tag"] == "Train_l_mse"]) == 6
    assert trainer.best_error == min(epe)
    for name in ("Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar"):
        assert (tmp_path / "run" / name).is_file()

    pairs = Chairs(str(root), split="train")
    img1, img2, gt = (torch.from_numpy(np.stack([pairs[i][k] if k != "flow" else
                                                 pairs[i]["target"]["flow"]
                                                 for i in range(4)]))
                      for k in ("img1", "img2", "flow"))
    fixed = _FixedNoise(trainer.loss_func, {"eps": torch.from_numpy(
        np.random.RandomState(35).randn(4, H // 4, W // 4, 2).astype(np.float32))})

    def fixed_batch_loss(model):
        with torch.no_grad():
            return float(fixed(model(img1, img2, with_bk=False), gt)["total"])

    assert fixed_batch_loss(trainer.model) < fixed_batch_loss(untrained)
