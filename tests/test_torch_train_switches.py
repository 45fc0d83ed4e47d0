"""The trainer switches of the port on the CPU at 64x96, as the JAX
package's tests hold its own (``tests/test_nan_revert.py``,
``tests/test_remat.py``, ``tests/test_stage1_switch.py``):

- ``train.nan_revert``: a step with a non-finite loss, or a finite loss and
  a non-finite gradient, leaves the parameters, the Adam moments, the
  schedule's count and the mixture weights net's BatchNorm statistics as
  they were, bit for bit, and counts in ``nan_skips``; the next finite step
  proceeds; the flush warns instead of raising, and raises without the
  switch;
- ``train.remat``: one step with level dropout on gives the parameters,
  BatchNorm statistics and generator state of the step without it, and
  its backward did recompute the levels;
- ``stage1``: the loss switch fires once, at the first epoch >= its
  epoch, also in a run that starts past it.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models import uflow as uflow_module
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.utils.meters import AverageMeter
from torch_port_util import H, W, few_torch_threads  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
TRAIN = {"batch_size": B, "epoch_num": 1, "epoch_size": 1000, "valid_size": 0,
         "valid_freq": 10**9, "optim": "adam", "lr": 1e-4, "beta1": 0.9,
         "beta2": 0.999, "weight_decay": 1e-6, "bias_decay": 0.0,
         "lr_decay_start_epoch": 300, "lr_decay_factor": 0.98,
         "print_freq": 1, "record_freq": 1, "save_iter": 10**9, "seed": 0}
UFLOW_LOSS = {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0,
              "smooth_order": 1, "edge_constant": 150.0, "with_bk": True}
log = logging.getLogger("test")


def _mixture_sections():
    """chairs_uflow_elbo_mixture.json's model (MixtureWeightsNet and its
    BatchNorms) and loss, two Monte-Carlo samples."""
    with open(os.path.join(REPO, "configs", "chairs_uflow_elbo_mixture.json")) as f:
        full = json.load(f)
    return full["model"], dict(full["loss"], n_samples=2)


def _setup(case, level_dropout, **train):
    """(model config, loss config, trainer name) of ``case``."""
    if case == "mixture":
        model, loss = _mixture_sections()
        return dict(model, level_dropout=level_dropout), loss, "uflow_elbo"
    return ({"type": "uflow", "feature_norm": True,
             "level_dropout": level_dropout}, UFLOW_LOSS, "uflow")


def _batch(seed, nan=False):
    rs = np.random.RandomState(seed)
    img1 = rs.rand(B, H, W, 3).astype(np.float32)
    img2 = np.roll(img1, (1, 2), axis=(1, 2)) * 0.9 + 0.05
    if nan:
        img1[0, 5, 7] = np.nan
    return {"img1": img1, "img2": img2.astype(np.float32)}


def _trainer(tmp_path, case, batches, level_dropout=0.0, stage1=None,
             **train):
    model_c, loss_c, name = _setup(case, level_dropout)
    full = {"model": model_c, "loss": loss_c,
            "train": dict(TRAIN, epoch_size=len(batches), **train)}
    if stage1 is not None:
        full["stage1"] = stage1
    full = Config(full)
    model = get_model(full.model, device="cpu")
    return get_trainer(name)(batches, None, model, get_loss(full.loss), log,
                             str(tmp_path), full.train, model_cfg=full.model,
                             full_cfg=full)


def _state(trainer):
    """Everything a step may change, cloned: parameters, buffers, the
    optimizer's state and the schedule's count."""
    opt = trainer.optimizer
    return {"params": [p.detach().clone() for p in trainer.model.parameters()],
            "buffers": [b.clone() for b in trainer.model.buffers()],
            "moments": [{k: v.clone() for k, v in opt.optimizer.state[p].items()}
                        for p in trainer.model.parameters()
                        if p in opt.optimizer.state],
            "count": opt.count}


def _assert_same(a, b):
    assert a["count"] == b["count"]
    for key in ("params", "buffers"):
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key
    assert len(a["moments"]) == len(b["moments"]) > 0
    for x, y in zip(a["moments"], b["moments"]):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("case", ["uflow", "mixture"])
def test_nonfinite_step_reverts_everything(tmp_path, case):
    """Finite, NaN, finite: the NaN step leaves the state as the first step
    left it, BatchNorm statistics included (the mixture case), and the
    third step updates it again."""
    trainer = _trainer(tmp_path, case, [_batch(0), _batch(1, nan=True),
                                        _batch(2)], nan_revert=True)
    inputs = [trainer._batch_inputs(b) for b in trainer.train_loader]
    trainer._ensure_init()
    trainer.train_step(*inputs[0])
    first = _state(trainer)
    if case == "mixture":
        assert len(first["buffers"]) == 60  # 20 BatchNorms
    metrics = trainer.train_step(*inputs[1])
    assert not torch.isfinite(metrics[0])
    assert trainer.nan_skips == 1
    _assert_same(_state(trainer), first)
    trainer.train_step(*inputs[2])
    assert trainer.nan_skips == 1
    assert trainer.optimizer.count == first["count"] + 1
    moved = [not torch.equal(p, q) for p, q in
             zip(trainer.model.parameters(), first["params"])]
    assert sum(moved) > len(moved) // 2
    if case == "mixture":
        assert any(not torch.equal(b, c) for b, c in
                   zip(trainer.model.buffers(), first["buffers"]))


def test_nonfinite_gradient_with_finite_loss_reverts(tmp_path):
    """One parameter's gradient made infinite by a hook: the loss is
    finite, and the step is reverted all the same."""
    trainer = _trainer(tmp_path, "uflow", [_batch(0)], nan_revert=True)
    inputs = trainer._batch_inputs(_batch(0))
    trainer._ensure_init()
    trainer.train_step(*inputs)
    first = _state(trainer)
    param = trainer.model._refine_model[0].bias
    handle = param.register_hook(lambda g: g * float("inf"))
    metrics = trainer.train_step(*inputs)
    handle.remove()
    assert torch.isfinite(metrics[0])
    assert trainer.nan_skips == 1
    _assert_same(_state(trainer), first)


def test_trainer_survives_a_poisoned_batch(tmp_path, caplog):
    """Through ``train()``: the NaN batch is skipped with a warning at the
    flush, its row stays out of the meters, ``nan_skips`` is saved with
    the checkpoint, and the parameters stay finite."""
    trainer = _trainer(tmp_path, "uflow", [_batch(1, nan=True), _batch(0)],
                       nan_revert=True)
    with caplog.at_level(logging.WARNING, logger="test"):
        trainer.train()
    assert any("reverted (nan_revert)" in r.message for r in caplog.records)
    assert trainer.nan_skips == 1 and trainer.i_iter == 2
    assert trainer.optimizer.count == 1
    assert all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters())
    trainer.save_model(1.0, "t")
    ckpt = torch.load(tmp_path / "t_ckpt.pth.tar", weights_only=False)
    assert ckpt["nan_skips"] == 1


def _flush(tmp_path, nan_revert):
    trainer = _trainer(tmp_path, "uflow", [_batch(0)], nan_revert=nan_revert,
                       print_freq=4, record_freq=4)
    meters, bt, dt = AverageMeter(i=1), AverageMeter(), AverageMeter()
    for i, v in enumerate([1.0, float("nan"), 0.5]):
        trainer.i_iter = i + 1
        trainer._queue_step_metrics(torch.tensor([v]), 2, i, meters, ["total"],
                                    bt, dt)
    trainer._flush_metrics(meters, ["total"], bt, dt)
    return meters


@pytest.mark.parametrize("nan_revert", [True, False])
def test_flush_warns_with_nan_revert_and_raises_without(tmp_path, caplog,
                                                        nan_revert):
    if not nan_revert:
        with pytest.raises(FloatingPointError, match="at iter 2 "):
            _flush(tmp_path, nan_revert)
        return
    with caplog.at_level(logging.WARNING, logger="test"):
        meters = _flush(tmp_path, nan_revert)
    assert any("reverted" in r.message for r in caplog.records)
    assert np.isclose(meters.avg[0], 0.75)  # the NaN row left out


@pytest.mark.parametrize("case", ["uflow", "mixture"])
def test_remat_step_equals_the_plain_step(tmp_path, case, monkeypatch):
    """One step with level dropout 0.5 (some levels dropped) with and
    without ``remat``: parameters within 1e-6 relative (measured: equal),
    BatchNorm statistics and the generator's state after the step equal.
    With remat the backward computes each level's cost volumes again."""
    from arflow_tpu_torch.models import uflow_prob as uflow_prob_module

    passes = []
    for module in (uflow_module, uflow_prob_module):
        def counting(*args, real=module.compute_cost_volume):
            passes.append(None)
            return real(*args)

        monkeypatch.setattr(module, "compute_cost_volume", counting)
    out = {}
    for remat in (False, True):
        trainer = _trainer(tmp_path / str(remat), case, [_batch(3)],
                           level_dropout=0.5, remat=remat)
        passes.clear()
        trainer.train()
        out[remat] = ({k: v.detach() for k, v in
                       trainer.model.named_parameters()},
                      list(trainer.model.buffers()),
                      trainer.generator.get_state(), len(passes))
    (p0, b0, g0, n0), (p1, b1, g1, n1) = out[False], out[True]
    assert n1 == 2 * n0 > 0
    assert torch.equal(g0, g1)
    assert sorted(p0) == sorted(p1)
    for name in p0:
        scale = float(p0[name].abs().max()) or 1.0
        assert float((p0[name] - p1[name]).abs().max()) <= 1e-6 * scale, name
    assert len(b0) == len(b1) == (60 if case == "mixture" else 0)
    for x, y in zip(b0, b1):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


def test_stage1_fires_once_and_after_a_resume(tmp_path):
    """``stage1.epoch`` 1: the loss config changes at the second epoch and
    only then (a later epoch leaves a restored value alone); a trainer that
    starts at epoch 2 applies it at its first epoch."""
    stage1 = {"epoch": 1, "loss": {"w_smooth": 0.0}}
    trainer = _trainer(tmp_path, "uflow", [_batch(0)], stage1=stage1,
                       epoch_num=3)
    trainer._run_one_epoch()
    assert trainer.loss_func.cfg.w_smooth == 4.0
    trainer._run_one_epoch()
    assert trainer.loss_func.cfg.w_smooth == 0.0
    trainer.loss_func.cfg.w_smooth = 4.0
    trainer._run_one_epoch()
    assert trainer.loss_func.cfg.w_smooth == 4.0  # fired once
    assert trainer.i_epoch == 3

    resumed = _trainer(tmp_path / "r", "uflow", [_batch(0)], stage1=stage1,
                       epoch_num=3)
    resumed.i_epoch = 2  # as a resume past the switch restores it
    resumed.train()
    assert resumed.loss_func.cfg.w_smooth == 0.0
