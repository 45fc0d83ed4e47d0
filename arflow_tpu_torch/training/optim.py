"""Optimizer with decay and no-decay parameter groups (port of
``arflow_tpu/training/optim.py`` for ``adam`` and ``sgd``).

Conv, deconv and linear weights get ``weight_decay``; biases and every
other parameter get ``bias_decay``. Both enter the gradient as an L2 term
before the moments, and only for parameters that have a gradient, which is
``torch.optim.Adam``'s and ``SGD``'s own ``weight_decay`` rule applied per
group (the JAX package's ``add_decayed_weights_if_used``). Gradients are
clipped to a global norm first when ``clip > 0``
(``torch.nn.utils.clip_grad_norm_``, whose ``+1e-6`` the JAX package's
``clip_by_global_norm_torch`` copies), and the learning rate follows the
gated exponential schedule per step.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_DECAY_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def decay_groups(model: nn.Module):
    """(decay, no_decay) parameter lists: the weights of conv, deconv and
    linear layers, and everything else."""
    decay = {id(m.weight): m.weight for m in model.modules()
             if isinstance(m, _DECAY_MODULES)}
    no_decay = [p for p in model.parameters() if id(p) not in decay]
    return list(decay.values()), no_decay


def lr_schedule(cfg, steps_per_epoch: int):
    """Step -> learning rate: ``cfg.lr``, times ``lr_decay_factor`` per
    epoch from ``lr_decay_start_epoch`` on."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        exponent = max(0, epoch - cfg.lr_decay_start_epoch + 1)
        return cfg.lr * cfg.lr_decay_factor**exponent

    return schedule


class Optimizer:
    """A torch optimizer with the step's gradient clipping and learning-rate
    schedule. ``step()`` clips, sets the step's learning rate, updates and
    counts the step."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule, clip: float):
        self.optimizer = optimizer
        self.schedule = schedule
        self.clip = clip
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip > 0:
            torch.nn.utils.clip_grad_norm_(
                [p for g in self.optimizer.param_groups for p in g["params"]],
                self.clip)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def create_optimizer(cfg, model: nn.Module, steps_per_epoch: int) -> Optimizer:
    """``cfg`` (the config's ``train`` section) -> the ``Optimizer`` of
    ``cfg.optim`` in {'adam', 'sgd'} over ``model``'s parameters."""
    decay, no_decay = decay_groups(model)
    groups = [
        {"params": decay, "weight_decay": cfg.get("weight_decay", 0.0)},
        {"params": no_decay, "weight_decay": cfg.get("bias_decay", 0.0)},
    ]
    if cfg.optim == "adam":
        opt = torch.optim.Adam(
            groups, lr=cfg.lr,
            betas=(cfg.get("beta1", 0.9), cfg.get("beta2", 0.999)),
            eps=cfg.get("eps", 1e-8))
    elif cfg.optim == "sgd":
        opt = torch.optim.SGD(groups, lr=cfg.lr,
                              momentum=cfg.get("momentum", 0.9))
    elif cfg.optim == "adamw":
        raise NotImplementedError(
            "optim 'adamw' (the reference's custom AdamW, scale_by_torch_adamw "
            "and torch_adamw_decay) is not ported yet: ROADMAP.md queue 1, "
            "'the PWC-Lite family'")
    else:
        raise NotImplementedError(cfg.optim)
    clip = cfg.get("clip", -1.0)
    return Optimizer(opt, lr_schedule(cfg, steps_per_epoch),
                     clip if clip and clip > 0 else 0.0)
