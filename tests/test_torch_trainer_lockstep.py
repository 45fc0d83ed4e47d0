"""Lockstep: the port's ``UFlowTrainer`` against ``arflow_tpu``'s from the
same weights, on the same in-memory batches, in float64, dropout off.

Two epochs of two steps at B=2, 64x96: Adam with L2 decay on the
conv weights and the learning-rate gate engaging in the second epoch; the
models predict on the ``_ph`` copies, which differ from the originals the
loss compares. ``lr=1e-7``, for the reason ``tests/test_lockstep_trajectory.py``
gives: at a production rate, Adam's normalized early steps amplify the
frameworks' float64 rounding differences step by step, while a semantic
difference (a mis-grouped decay, a wrong gate epoch, the loss on the wrong
images) moves the parameters by O(lr), far above this test's bounds.

The JAX trainer trims each batch to a multiple of its mesh's devices; it
gets a one-device mesh, so that B=2 steps.
"""

import logging

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowLoss as JaxUFlowLoss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.parallel import make_mesh, replicate
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu.training.uflow_trainer import UFlowTrainer as JaxUFlowTrainer
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import UFlowLoss
from arflow_tpu_torch.models import get_model, uflow_state_dict_from_jax
from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    H,
    W,
    few_torch_threads,
    jax_params,
)

B, EPOCHS, STEPS = 2, 2, 2
GATES_OFF = {"ARFLOW_WFOLD_PYR": "0", "ARFLOW_PYR_BATCH": "0", "ARFLOW_HFOLD": "0"}
LOSS_CFG = {"type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
            "w_census": 1.0, "smooth_order": 1, "with_bk": True}
TRAIN_CFG = {
    "batch_size": B, "epoch_num": EPOCHS, "epoch_size": 1000, "lr": 1e-7,
    "lr_decay_start_epoch": 1, "lr_decay_factor": 0.5, "optim": "adam",
    "beta1": 0.9, "beta2": 0.999, "eps": 1e-8, "weight_decay": 1e-2,
    "bias_decay": 0.0, "pretrained_model": None, "print_freq": 100,
    "record_freq": 1, "save_iter": 10**9, "valid_freq": 10**9,
    "valid_size": 0, "seed": 0, "clip": -1.0,
}
log = logging.getLogger("lockstep")


class _JaxRecording(JaxUFlowTrainer):
    def _queue_step_metrics(self, metrics, *a, **k):
        self.records = getattr(self, "records", []) + [
            [float(metrics[key]) for key in ("total", "l_ph", "l_sm")]]
        super()._queue_step_metrics(metrics, *a, **k)


class _PortRecording(UFlowTrainer):
    def _queue_step_metrics(self, metrics, *a, **k):
        self.records = getattr(self, "records", []) + [metrics[:3].tolist()]
        super()._queue_step_metrics(metrics, *a, **k)


def _batches():
    rs = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        b = {"img1": rs.rand(B, H, W, 3), "img2": rs.rand(B, H, W, 3)}
        b["img1_ph"] = np.clip(b["img1"] * 1.15 + 0.02, 0.0, 1.0)
        b["img2_ph"] = np.clip(b["img2"] * 1.15 + 0.02, 0.0, 1.0)
        out.append(b)
    return out


def test_uflow_trainer_lockstep_f64(jax_params, monkeypatch, tmp_path):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    batches = _batches()
    cfg = dict(CFG, level_dropout=0.0)

    # JAX: the trainer with its state set from the shared weights (which
    # its jitted step donates).
    params0 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64),
                                     jax_params)
    mesh = make_mesh(devices=np.array(jax.devices()[:1]))
    tr_j = _JaxRecording(batches, None, jax_get_model(JaxConfig(cfg)),
                         JaxUFlowLoss(JaxConfig(LOSS_CFG)), log,
                         str(tmp_path / "jax"), JaxConfig(TRAIN_CFG),
                         model_cfg=JaxConfig(cfg), mesh=mesh)
    tr_j.tx = jax_create_optimizer(JaxConfig(TRAIN_CFG), params0, STEPS)
    tr_j.state = replicate(mesh, {"params": params0,
                                  "opt_state": tr_j.tx.init(params0),
                                  "step": jnp.zeros((), jnp.int32)})
    tr_j._train_step = tr_j._build_train_step()
    tr_j.train()

    # The port.
    model = get_model(Config(cfg), device="cpu")
    model.load_state_dict(uflow_state_dict_from_jax(jax_params), strict=True)
    model = model.to(torch.float64)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    tr_t = _PortRecording(batches, None, model, UFlowLoss(Config(LOSS_CFG)),
                          log, str(tmp_path / "port"), Config(TRAIN_CFG),
                          model_cfg=Config(cfg))
    tr_t.train()

    assert tr_t.i_iter == tr_j.i_iter == EPOCHS * STEPS
    assert tr_t.optimizer.count == EPOCHS * STEPS
    # float64 losses through the same math (the JAX lockstep's own bound).
    np.testing.assert_allclose(np.array(tr_t.records), np.array(tr_j.records),
                               rtol=1e-8, atol=1e-12)

    # Parameter updates: final minus initial on both sides. The converter
    # stores float32, which keeps 7 digits of these ~1e-7 updates.
    delta_j = uflow_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b, np.float64),
        jax.device_get(tr_j.state["params"]), jax_params))
    moved = 0
    for name, v in model.state_dict().items():
        delta_t = (v - sd0[name]).float()
        torch.testing.assert_close(delta_t, delta_j[name], rtol=0, atol=1e-10,
                                   msg=name)
        moved += int(delta_t.abs().max() > 0)
    assert moved > 90  # all but the never-applied context deconvs
