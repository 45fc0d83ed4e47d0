"""Lockstep: the port's ``UFlowElboTrainer`` against ``arflow_tpu``'s from
the same weights on the same in-memory batches, in float64, with
``configs/chairs_uflow_elbo.json``'s model (dropout off) and loss.

Two epochs of two steps at B=2, 64x96: Adam with L2 decay and the
learning-rate gate engaging in the second epoch, ``lr=1e-7`` for the
reason ``tests/test_torch_trainer_lockstep.py`` gives. Each side's loss is
wrapped to take the same fixed noise at every step. The batches carry
photometric copies that differ from the originals: the ELBO trainers
predict on the plain images. The JAX trainer gets a one-device mesh.
"""

import logging

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowElboLoss as JaxElboLoss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.parallel import make_mesh, replicate
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu.training.uflow_elbo_trainer import UFlowElboTrainer as JaxElboTrainer
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model, uflow_prob_state_dict_from_jax
from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer
from test_torch_elbo_trainer import B, EPOCHS, KEYS, sections
from torch_port_util import H, W, draw_jax_params, few_torch_threads  # noqa: F401
from torch_prob_util import GATES_OFF

STEPS = 2
log = logging.getLogger("lockstep")


class _FixedNoise:
    """A loss that takes the same injected noise at every call."""

    def __init__(self, loss, noise):
        self.loss, self.noise, self.cfg = loss, noise, loss.cfg

    def __call__(self, res, img1, img2, rng=None, generator=None):
        return self.loss(res, img1, img2, noise=self.noise)


class _JaxRecording(JaxElboTrainer):
    def _queue_step_metrics(self, metrics, *a, **k):
        self.records = getattr(self, "records", []) + [
            [float(metrics[key]) for key in KEYS]]
        super()._queue_step_metrics(metrics, *a, **k)


class _PortRecording(UFlowElboTrainer):
    def _queue_step_metrics(self, metrics, *a, **k):
        self.records = getattr(self, "records", []) + [metrics.tolist()]
        super()._queue_step_metrics(metrics, *a, **k)


def test_elbo_trainer_lockstep_f64(monkeypatch, tmp_path):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    model_c, loss_c, train_c = sections()
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(STEPS):
        b = {"img1": rs.rand(B, H, W, 3), "img2": rs.rand(B, H, W, 3)}
        # photometric copies, which the ELBO trainer must not predict on
        b["img1_ph"] = np.clip(b["img1"] * 1.15 + 0.02, 0.0, 1.0)
        b["img2_ph"] = np.clip(b["img2"] * 1.15 + 0.02, 0.0, 1.0)
        batches.append(b)
    noise = {k: rs.randn(B, H // 4, W // 4, 2) for k in ("eps12", "eps21")}
    params = draw_jax_params(model_c, seed=0, with_bk=True)

    params0 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), params)
    mesh = make_mesh(devices=np.array(jax.devices()[:1]))
    loss_j = _FixedNoise(JaxElboLoss(JaxConfig(loss_c)),
                         {k: jnp.asarray(v) for k, v in noise.items()})
    tr_j = _JaxRecording(batches, None, jax_get_model(JaxConfig(model_c)), loss_j,
                         log, str(tmp_path / "jax"), JaxConfig(train_c),
                         model_cfg=JaxConfig(model_c), mesh=mesh)
    tr_j.tx = jax_create_optimizer(JaxConfig(train_c), params0, STEPS)
    tr_j.state = replicate(mesh, {"params": params0,
                                  "opt_state": tr_j.tx.init(params0),
                                  "step": jnp.zeros((), jnp.int32)})
    tr_j._train_step = tr_j._build_train_step()
    tr_j.train()

    model = get_model(Config(model_c), device="cpu")
    model.load_state_dict(uflow_prob_state_dict_from_jax(params), strict=True)
    model = model.double()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    loss_t = _FixedNoise(get_loss(Config(loss_c)),
                         {k: torch.from_numpy(v) for k, v in noise.items()})
    tr_t = _PortRecording(batches, None, model, loss_t, log,
                          str(tmp_path / "port"), Config(train_c),
                          model_cfg=Config(model_c))
    tr_t.train()

    assert tr_t.i_iter == tr_j.i_iter == EPOCHS * STEPS
    assert tr_t.optimizer.count == EPOCHS * STEPS
    # float64 losses through the same math (the JAX lockstep's own bound)
    np.testing.assert_allclose(np.array(tr_t.records), np.array(tr_j.records),
                               rtol=1e-8, atol=1e-12)
    # Parameter updates, final minus initial on both sides; the converter
    # stores float32, which keeps 7 digits of these ~1e-7 updates.
    delta_j = uflow_prob_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b, np.float64),
        jax.device_get(tr_j.state["params"]), params))
    moved = 0
    for name, v in model.state_dict().items():
        delta_t = (v - sd0[name]).float()
        torch.testing.assert_close(delta_t, delta_j[name], rtol=0, atol=1e-10,
                                   msg=name)
        moved += int(delta_t.abs().max() > 0)
    assert moved > 90  # all but the context deconvs that reach no output
