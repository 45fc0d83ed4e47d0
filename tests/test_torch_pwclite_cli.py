"""``train_main(device="cpu")`` with the PWC-Lite family's training
configuration (``pwclite``, the ``unflow`` loss of the JAX package's
PWC-Lite train step, ``optim: adamw``) on a synthetic FlyingChairs
directory at 64x64: two epochs with validation and checkpoints unbroken
(A), one epoch (B), and a resume of B's checkpoint (C), which must end
where A ends bit for bit: weights, the AdamW moments and per-parameter
steps, the schedule's count, the counters and the events."""

import logging

import numpy as np
import torch

from arflow_tpu_torch import Config, cli
from arflow_tpu_torch.training.checkpoint import load_checkpoint
from arflow_tpu_torch.training.optim import ReferenceAdamW
from test_torch_checkpoint import _events, assert_state_equal
from test_torch_pwclite_train import PWCLITE, UNFLOW
from torch_data_util import make_shifted_chairs_dir
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)

H, W = 64, 64
log = logging.getLogger("test")
TRAIN = {"batch_size": 2, "epoch_num": 2, "epoch_size": 1000, "valid_size": 0,
         "valid_freq": 1, "optim": "adamw", "lr": 1e-4, "momentum": 0.9,
         "beta": 0.999, "weight_decay": 1e-4, "bias_decay": 1e-5,
         "lr_decay_start_epoch": 1, "lr_decay_factor": 0.5, "print_freq": 1,
         "record_freq": 1, "save_iter": 0, "workers": 2, "clip": 5.0}


def _run(root, save_root, epoch_num, resume=None):
    """train_main on the CPU over ``root`` with no augmentation."""
    data = [{"root_chairs": str(root), "type": t, "name": "Chairs",
             "n_frames": 2} for t in ("train", "valid")]
    cfg = Config({"seed": 0, "save_root": str(save_root), "trainer": "uflow",
                  "data": data, "model": PWCLITE, "loss": UNFLOW,
                  "train": dict(TRAIN, epoch_num=epoch_num)})
    if resume:
        cfg.train.resume = str(resume)
    return cli.train_main(cfg, log, device="cpu")


def test_train_main_adamw_resume_bit_for_bit(tmp_path):
    # fids 1-6: fid 6 is the valid split, 5 train pairs make 2 batches of 2
    root = make_shifted_chairs_dir(tmp_path / "chairs",
                                   np.random.RandomState(4), 6, H, W)
    tr_a = _run(root, tmp_path / "a", epoch_num=2)
    tr_b = _run(root, tmp_path / "b", epoch_num=1)
    tr_c = _run(root, tmp_path / "c", epoch_num=2,
                resume=tmp_path / "b" / "Chairs_ckpt.pth.tar")
    assert isinstance(tr_a.optimizer.optimizer, ReferenceAdamW)
    assert (tr_a.i_epoch, tr_a.i_iter) == (tr_c.i_epoch, tr_c.i_iter) == (2, 4)
    events_a, events_c = _events(tmp_path / "a"), _events(tmp_path / "c")
    epes = [v for tag, _, v in events_a if tag == "Valid_EPE_0"]
    assert len(epes) == 2 and np.isfinite(epes).all()
    assert events_c == [e for e in events_a if e[1] >= 2]
    assert_state_equal(tr_c.model.state_dict(), tr_a.model.state_dict(), "weights")
    state_a = tr_a.optimizer.optimizer.state_dict()
    assert_state_equal(tr_c.optimizer.optimizer.state_dict(), state_a, "adamw")
    steps = {int(s["step"]) for s in state_a["state"].values()}
    assert steps == {4}  # every parameter reached by the loss at each step
    assert tr_c.optimizer.count == tr_a.optimizer.count == 4
    assert tr_c.best_error == tr_a.best_error == min(epes)
    # the first epoch moved the weights: the comparison is not of two
    # untrained runs
    first = load_checkpoint(str(tmp_path / "b" / "Chairs_ckpt.pth.tar"))
    name = "context_networks.convs.6.0.weight"
    assert not torch.equal(first["state_dict"][name],
                           tr_a.model.state_dict()[name])
