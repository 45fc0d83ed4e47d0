"""Optimizer with decay and no-decay parameter groups (port of
``arflow_tpu/training/optim.py``: ``adam``, ``sgd`` and ``adamw``).

Conv, deconv and linear weights get ``weight_decay``; biases and every
other parameter get ``bias_decay``. For ``adam`` and ``sgd`` both enter the
gradient as an L2 term before the moments, and only for parameters that
have a gradient, which is ``torch.optim.Adam``'s and ``SGD``'s own
``weight_decay`` rule applied per group (the JAX package's
``add_decayed_weights_if_used``). ``adamw`` is the reference's own AdamW
(``ReferenceAdamW``), whose decay is decoupled and not scaled by the
learning rate. Gradients are clipped to a global norm first when
``clip > 0`` (``torch.nn.utils.clip_grad_norm_``, whose ``+1e-6`` the JAX
package's ``clip_by_global_norm_torch`` copies), and the learning rate
follows the gated exponential schedule per step.
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


class ReferenceAdamW(torch.optim.Optimizer):
    """The reference's AdamW, as the JAX package's ``scale_by_torch_adamw``
    and ``torch_adamw_decay`` chain it. Per parameter, with its own step
    count t:

        m <- b1 m + (1 - b1) g,  v <- b2 v + (1 - b2) g^2,  t <- t + 1
        p <- p - lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps)
        p <- p (1 - weight_decay)

    ``eps`` is added to the uncorrected ``sqrt(v)``; the gradient carries
    no L2 term, and the decay follows the step, unscaled by the learning
    rate. A parameter whose gradient is None or all zeros is frozen: its
    moments do not decay, its count does not grow, and it is not decayed
    (torch skips a None gradient; the JAX chain gates on ``any(g != 0)``).
    The gate is computed on the device, without a read on the host. The
    state (``exp_avg``, ``exp_avg_sq``, an int32 ``step``) is a torch
    optimizer's, and saves and loads as one."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                # a loaded state's step keeps the device it was saved from
                step = state["step"].to(p.device)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                used = (g != 0).any()
                m.copy_(torch.where(used, b1 * m + (1.0 - b1) * g, m))
                v.copy_(torch.where(used, b2 * v + (1.0 - b2) * g * g, v))
                step = step + used.to(torch.int32)
                state["step"] = step
                t = step.clamp_min(1).to(p.dtype)
                scaled = ((1.0 - b2**t).sqrt() / (1.0 - b1**t)) * m / (
                    v.sqrt() + eps)
                update = torch.where(used, scaled, 0.0) * -lr
                if wd:
                    update = torch.where((update != 0).any(),
                                         update * (1.0 - wd) - wd * p, update)
                p.add_(update)


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
    ``cfg.optim`` in {'adam', 'sgd', 'adamw'} over ``model``'s parameters;
    ``adamw`` reads its betas from ``momentum`` and ``beta``, as the JAX
    package does."""
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
        opt = ReferenceAdamW(groups, lr=cfg.lr,
                             betas=(cfg.get("momentum", 0.9),
                                    cfg.get("beta", 0.999)))
    else:
        raise NotImplementedError(cfg.optim)
    clip = cfg.get("clip", -1.0)
    return Optimizer(opt, lr_schedule(cfg, steps_per_epoch),
                     clip if clip and clip > 0 else 0.0)
