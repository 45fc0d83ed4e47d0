"""The port's ``UFlowElboTrainer`` with chairs_uflow_elbo_mixture.json's
model (two pyramids and ``MixtureWeightsNet``) on the CPU at 64x96, b2:

- in lockstep with the JAX trainer for two steps in float64, the
  BatchNorm statistics in both trainers' state;
- a resumed ``train_main`` run equal bit for bit to an unbroken one, the
  BatchNorm buffers included.
"""

import json
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
from arflow_tpu_torch import Config, cli, load_config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model, uflow_prob_state_dict_from_jax
from test_torch_checkpoint import assert_state_equal
from test_torch_mixture_elbo import B, CONFIG, LOSS_RTOL, TERMS, draws, loss_section
from torch_data_util import make_shifted_chairs_dir
from torch_mixture_util import MIXTURE, as_f64, draw_variables, image_pair, stats_gap
from torch_port_util import H, W, few_torch_threads  # noqa: F401
from torch_prob_util import GATES_OFF

log = logging.getLogger("test")
# A downsample conv's bias feeds a BatchNorm in training mode, so its
# gradient is rounding noise on either side, which Adam scales to a step
# of up to lr in an arbitrary direction: the three biases part by up to
# 2e-7 after two steps at lr 1e-7, and the running means of the three
# BatchNorms after them by a tenth of that (measured 4.2e-10 relative to
# the largest statistic). Every other parameter's update is held at
# 1e-10, and the other statistics follow the same bound.
PRE_BN_BIASES = tuple(f"_mixture_weights_net.resnet.layer{s}.0.downsample.0.bias"
                      for s in (1, 2, 3))
STATS_RTOL = 1e-8


@pytest.fixture(autouse=True)
def gates_off(monkeypatch):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")


class _FixedNoise:
    """A loss that takes the same injected noise at every call."""

    def __init__(self, loss, noise):
        self.loss, self.noise, self.cfg = loss, noise, loss.cfg

    def __call__(self, res, img1, img2, rng=None, generator=None):
        return self.loss(res, img1, img2, noise=self.noise)


def test_mixture_trainer_lockstep_f64(tmp_path):
    """The JAX ``UFlowElboTrainer`` (one-device mesh, its BatchNorm
    statistics in the state) against the port's: two epochs of one step,
    Adam with L2 decay, the learning-rate gate engaging in the second
    epoch, lr 1e-7 as ``test_torch_elbo_lockstep.py`` has it, the same
    fixed draws at each step."""
    from arflow_tpu.parallel import make_mesh, replicate
    from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
    from arflow_tpu.training.uflow_elbo_trainer import UFlowElboTrainer as JaxTrainer
    from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer

    loss_c = dict(loss_section(), n_samples=2)
    with open(CONFIG) as f:
        train_c = dict(json.load(f)["train"], batch_size=B, epoch_num=2,
                       epoch_size=1000, lr=1e-7, lr_decay_start_epoch=1,
                       lr_decay_factor=0.5, weight_decay=1e-2, print_freq=100,
                       record_freq=1, save_iter=10**9, valid_freq=10**9, seed=0)
    img1, img2 = image_pair(B, seed=24)
    batches = [{"img1": img1, "img2": img2}]
    noise = draws(seed=25, n=2)
    jmodel = jax_get_model(JaxConfig(MIXTURE))
    img = jnp.zeros((B, H, W, 3), jnp.float32)
    variables = draw_variables(jmodel, (img, img), seed=26, with_bk=True)
    v64 = as_f64(variables)

    records = {"jax": [], "port": []}

    class JaxRecording(JaxTrainer):
        def _queue_step_metrics(self, metrics, *a, **k):
            records["jax"].append([float(metrics[key]) for key in TERMS])
            super()._queue_step_metrics(metrics, *a, **k)

    class PortRecording(UFlowElboTrainer):
        def _queue_step_metrics(self, metrics, *a, **k):
            records["port"].append(metrics.tolist())
            super()._queue_step_metrics(metrics, *a, **k)

    mesh = make_mesh(devices=np.array(jax.devices()[:1]))
    loss_j = _FixedNoise(JaxElboLoss(JaxConfig(loss_c)),
                         {k: jnp.asarray(v) for k, v in noise.items()})
    tr_j = JaxRecording(batches, None, jmodel, loss_j, log, str(tmp_path / "jax"),
                        JaxConfig(train_c), model_cfg=JaxConfig(MIXTURE), mesh=mesh)
    tr_j.tx = jax_create_optimizer(JaxConfig(train_c), v64["params"], 1)
    tr_j._has_batch_stats = True
    tr_j.state = replicate(mesh, {"params": v64["params"],
                                  "batch_stats": v64["batch_stats"],
                                  "opt_state": tr_j.tx.init(v64["params"]),
                                  "step": jnp.zeros((), jnp.int32)})
    tr_j._train_step = tr_j._build_train_step()
    tr_j.train()

    model = get_model(Config(MIXTURE), device="cpu")
    model.load_state_dict(uflow_prob_state_dict_from_jax(variables), strict=True)
    model = model.double()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    loss_t = _FixedNoise(get_loss(Config(loss_c)),
                         {k: torch.from_numpy(v) for k, v in noise.items()})
    tr_t = PortRecording(batches, None, model, loss_t, log, str(tmp_path / "port"),
                         Config(train_c), model_cfg=Config(MIXTURE))
    tr_t.train()

    assert tr_t.i_iter == tr_j.i_iter == 2
    np.testing.assert_allclose(np.array(records["port"]), np.array(records["jax"]),
                               rtol=LOSS_RTOL, atol=1e-12)
    state_j = jax.device_get(tr_j.state)
    assert stats_gap(model._mixture_weights_net.resnet,
                     state_j["batch_stats"]["mixture_weights_net"]["resnet"],
                     "") < STATS_RTOL
    assert int(model._mixture_weights_net.resnet.conv1[1].num_batches_tracked) == 4
    # Parameter updates, final minus initial on both sides (about 1e-7
    # each; the converter stores float32, which keeps 7 digits of them).
    delta_j = uflow_prob_state_dict_from_jax({
        "params": jax.tree_util.tree_map(
            lambda a, b: np.asarray(a) - np.asarray(b, np.float64),
            state_j["params"], variables["params"]),
        "batch_stats": variables["batch_stats"]})
    moved = 0
    for name, _ in model.named_parameters():
        delta_t = (model.state_dict()[name] - sd0[name]).float()
        if name in PRE_BN_BIASES:
            assert float(delta_t.abs().max()) <= 2.1e-7, name
            continue
        torch.testing.assert_close(delta_t, delta_j[name], rtol=0, atol=1e-10,
                                   msg=name)
        moved += int(delta_t.abs().max() > 0)
    assert moved > 150


def test_mixture_resume_continues_bit_for_bit(tmp_path):
    """The mixture config's model, loss and train sections on a FlyingChairs
    directory (its own data section is the older schema): two epochs
    unbroken (A) against one (B) and a resume of B's checkpoint (C), level
    dropout and the loss's draws from the checkpointed generator, the
    BatchNorm buffers from the checkpoint."""
    root = make_shifted_chairs_dir(tmp_path / "chairs", np.random.RandomState(27),
                                   6, H, W)

    def cfg_of(save_root, epochs, resume=None):
        cfg = load_config(CONFIG)
        cfg.data = [{"root_chairs": str(root), "type": "train", "name": "Chairs",
                     "n_frames": 2},
                    {"root_chairs": str(root), "type": "valid", "name": "Chairs",
                     "n_frames": 2}]
        cfg.save_root = str(save_root)
        cfg.loss.n_samples = 2
        cfg.train.update(batch_size=2, valid_batch_size=1, epoch_num=epochs,
                         valid_freq=1, save_iter=0, workers=2, print_freq=1,
                         record_freq=1, lr_decay_start_epoch=1)
        if resume is not None:
            cfg.train.resume = str(resume)
        return cfg

    tr_a = cli.train_main(cfg_of(tmp_path / "a", 2), log, device="cpu")
    cli.train_main(cfg_of(tmp_path / "b", 1), log, device="cpu")
    tr_c = cli.train_main(cfg_of(tmp_path / "c", 2,
                                 resume=tmp_path / "b" / "Chairs_ckpt.pth.tar"),
                          log, device="cpu")
    assert (tr_a.i_epoch, tr_a.i_iter) == (tr_c.i_epoch, tr_c.i_iter) == (2, 4)
    sd = tr_a.model.state_dict()
    assert sum(k.endswith("running_var") for k in sd) == 20
    assert int(sd["_mixture_weights_net.resnet.conv1.1.num_batches_tracked"]) == 8
    assert_state_equal(tr_c.model.state_dict(), sd, "weights and buffers")
    assert_state_equal(tr_c.optimizer.optimizer.state_dict(),
                       tr_a.optimizer.optimizer.state_dict(), "adam")
    assert_state_equal(tr_c.generator.get_state(), tr_a.generator.get_state(),
                       "generator")
    assert tr_c.best_error == tr_a.best_error
