"""The port's ``create_optimizer`` against ``arflow_tpu.training.optim``:
50 steps on the same synthetic float64 gradients, as
``tests/test_lockstep_optimizer.py`` runs the JAX optimizer against torch.

Covered: decay and no-decay groups (conv weights against biases and other
parameters), both decays nonzero, global-norm clipping engaged on some
steps and not others, the exponential learning-rate gate engaging after
two epochs, and a parameter that never has a gradient (None in torch,
zeros in JAX), which must not move.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu_torch import Config
from arflow_tpu_torch.training.optim import create_optimizer
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

STEPS_PER_EPOCH = 10
N_STEPS = 50
# JAX tree: 'kernel' leaves (HWIO) are the decay group.
SHAPES = {
    "conv1": {"kernel": (3, 3, 2, 4), "bias": (4,)},
    "conv2": {"kernel": (3, 3, 4, 4), "bias": (4,)},
    "norm": {"scale": (4,), "bias": (4,)},
    "dead": {"kernel": (2, 2, 4, 2), "bias": (2,)},
}


class Net(nn.Module):
    """The torch counterpart of ``SHAPES``: conv weights OIHW."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 4, 3)
        self.conv2 = nn.Conv2d(4, 4, 3)
        self.dead = nn.Conv2d(4, 2, 2)
        self.norm_scale = nn.Parameter(torch.zeros(4))
        self.norm_bias = nn.Parameter(torch.zeros(4))

    def leaves(self):
        """(JAX module, leaf) -> the torch parameter."""
        out = {}
        for m in ("conv1", "conv2", "dead"):
            out[(m, "kernel")] = getattr(self, m).weight
            out[(m, "bias")] = getattr(self, m).bias
        out[("norm", "scale")] = self.norm_scale
        out[("norm", "bias")] = self.norm_bias
        return out


def _to_torch(leaf, a):
    return np.transpose(a, (3, 2, 0, 1)) if leaf == "kernel" else a


def _cfg(**kw):
    cfg = {"lr": 1e-3, "lr_decay_start_epoch": 2, "lr_decay_factor": 0.5,
           "weight_decay": 1e-2, "bias_decay": 1e-3, "clip": 5.0,
           "beta1": 0.9, "beta2": 0.999, "eps": 1e-8, "momentum": 0.9}
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_optimizer_matches_jax_50_steps(optim):
    cfg = _cfg(optim=optim)
    rs = np.random.RandomState(0)
    params0 = {m: {n: rs.randn(*s) for n, s in sub.items()}
               for m, sub in SHAPES.items()}
    grads = []
    for t in range(N_STEPS):
        scale = 25.0 if t % 3 == 2 else 0.5  # clipping engages every 3rd step
        grads.append({m: {n: (np.zeros(s) if m == "dead" else scale * rs.randn(*s))
                          for n, s in sub.items()} for m, sub in SHAPES.items()})

    net = Net().double()
    leaves = net.leaves()
    with torch.no_grad():
        for (m, n), p in leaves.items():
            p.copy_(torch.from_numpy(_to_torch(n, params0[m][n])))
    opt = create_optimizer(Config(cfg), net, STEPS_PER_EPOCH)

    tx = jax_create_optimizer(JaxConfig(cfg), params0, STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, params0)
    state = tx.init(params)

    for t, g in enumerate(grads):
        opt.zero_grad()
        for (m, n), p in leaves.items():
            if m != "dead":
                p.grad = torch.from_numpy(_to_torch(n, g[m][n]).copy())
        opt.step()
        gj = jax.tree_util.tree_map(jnp.asarray, g)
        updates, state = tx.update(gj, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for (m, n), p in leaves.items():
            # float64 rounding of the same updates in other orders.
            np.testing.assert_allclose(
                p.detach().numpy(), _to_torch(n, np.asarray(params[m][n])),
                rtol=1e-11, atol=1e-11, err_msg=f"step {t} {m}/{n}")
    assert opt.count == N_STEPS
    for (m, n), p in leaves.items():
        if m == "dead":
            np.testing.assert_array_equal(p.detach().numpy(),
                                          _to_torch(n, params0[m][n]))


def test_lr_schedule_gate():
    opt = create_optimizer(Config(_cfg(optim="adam")), Net(), STEPS_PER_EPOCH)
    # Constant through epochs 0 and 1, then halved per epoch from epoch 2.
    lrs = [opt.schedule(s) for s in (0, 19, 20, 29, 30, 40)]
    assert lrs == [1e-3, 1e-3, 1e-3 * 0.5, 1e-3 * 0.5, 1e-3 * 0.25,
                   1e-3 * 0.125]

