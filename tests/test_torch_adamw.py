"""The port's ``optim: adamw`` (``ReferenceAdamW``) against the JAX
package's optax chain (``clip_by_global_norm_torch``,
``scale_by_torch_adamw``, the learning rate, ``torch_adamw_decay``): 30
steps on the same synthetic float64 gradients, parameters, moments and
per-parameter step counts after every step.

Covered: both decays nonzero (conv weights against biases and other
parameters), global-norm clipping engaged on some steps, the
learning-rate gate engaging after two epochs, a parameter whose gradient
is all zeros on some steps (frozen on those: no moment decay, no count,
no decay) and one that never has a gradient (None in torch, zeros in
JAX). And a state saved half-way and loaded into a new optimizer, which
continues the unbroken run bit for bit.
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.training.optim import ScaleByTorchAdamWState
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu_torch import Config
from arflow_tpu_torch.training.optim import ReferenceAdamW, create_optimizer
from test_torch_optim import SHAPES, STEPS_PER_EPOCH, Net, _to_torch
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

N_STEPS = 30
CFG = {"optim": "adamw", "lr": 1e-3, "lr_decay_start_epoch": 2,
       "lr_decay_factor": 0.5, "weight_decay": 1e-2, "bias_decay": 1e-3,
       "clip": 5.0, "momentum": 0.9, "beta": 0.999}


def _grads():
    rs = np.random.RandomState(0)
    grads = []
    for t in range(N_STEPS):
        scale = 25.0 if t % 3 == 2 else 0.5  # clipping engages every 3rd step
        g = {m: {n: (np.zeros(s) if m == "dead" else scale * rs.randn(*s))
                 for n, s in sub.items()} for m, sub in SHAPES.items()}
        if t % 4 == 1:  # the norm's scale gets an all-zero gradient
            g["norm"]["scale"] = np.zeros(SHAPES["norm"]["scale"])
        grads.append(g)
    return grads


def _adamw_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, ScaleByTorchAdamWState))
        if isinstance(s, ScaleByTorchAdamWState))


def _port_step(opt, leaves, g):
    opt.zero_grad()
    for (m, n), p in leaves.items():
        if m != "dead":
            p.grad = torch.from_numpy(_to_torch(n, g[m][n]).copy())
    opt.step()


def test_adamw_matches_jax_30_steps():
    rs = np.random.RandomState(1)
    params0 = {m: {n: rs.randn(*s) for n, s in sub.items()}
               for m, sub in SHAPES.items()}
    net = Net().double()
    leaves = net.leaves()
    with torch.no_grad():
        for (m, n), p in leaves.items():
            p.copy_(torch.from_numpy(_to_torch(n, params0[m][n])))
    opt = create_optimizer(Config(CFG), net, STEPS_PER_EPOCH)
    assert isinstance(opt.optimizer, ReferenceAdamW)

    tx = jax_create_optimizer(JaxConfig(CFG), params0, STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, params0)
    state = tx.init(params)
    update = jax.jit(tx.update)

    zero_steps = 0
    for t, g in enumerate(_grads()):
        zero_steps += int(t % 4 == 1)
        _port_step(opt, leaves, g)
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, g), state,
                                params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        adamw = _adamw_state(state)
        for (m, n), p in leaves.items():
            msg = f"step {t} {m}/{n}"
            # float64 rounding of the same updates in other orders.
            np.testing.assert_allclose(
                p.detach().numpy(), _to_torch(n, np.asarray(params[m][n])),
                rtol=1e-11, atol=1e-11, err_msg=msg)
            st = opt.optimizer.state.get(p)
            if m == "dead":  # never a gradient: no state, never moved
                assert not st
                continue
            for key, jax_tree in (("exp_avg", adamw.mu), ("exp_avg_sq", adamw.nu)):
                np.testing.assert_allclose(
                    st[key].numpy(), _to_torch(n, np.asarray(jax_tree[m][n])),
                    rtol=1e-12, atol=1e-14, err_msg=f"{msg} {key}")
            assert int(st["step"]) == int(adamw.count[m][n]), msg
    assert opt.count == N_STEPS
    counts = {(m, n): int(opt.optimizer.state[p]["step"])
              for (m, n), p in leaves.items() if m != "dead"}
    assert counts[("norm", "scale")] == N_STEPS - zero_steps
    assert counts[("conv1", "kernel")] == N_STEPS
    for (m, n), p in leaves.items():
        if m == "dead":
            np.testing.assert_array_equal(p.detach().numpy(),
                                          _to_torch(n, params0[m][n]))


def test_adamw_state_round_trip():
    """Saved after 15 steps and loaded into a fresh optimizer over a copy
    of the parameters, the run goes on bit for bit."""
    grads = _grads()
    torch.manual_seed(0)
    nets = [Net().double(), Net().double()]
    nets[1].load_state_dict(nets[0].state_dict())
    opts = [create_optimizer(Config(CFG), n, STEPS_PER_EPOCH) for n in nets]
    for g in grads[:15]:
        _port_step(opts[0], nets[0].leaves(), g)
    saved = {"net": {k: v.clone() for k, v in nets[0].state_dict().items()},
             "opt": copy.deepcopy(opts[0].optimizer.state_dict()),
             "count": opts[0].count}
    nets[1].load_state_dict(saved["net"])
    opts[1].optimizer.load_state_dict(saved["opt"])
    opts[1].count = saved["count"]
    for g in grads[15:]:
        for net, opt in zip(nets, opts):
            _port_step(opt, net.leaves(), g)
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    for p0, p1 in zip(nets[0].parameters(), nets[1].parameters()):
        s0, s1 = opts[0].optimizer.state.get(p0, {}), opts[1].optimizer.state.get(p1, {})
        assert sorted(s0) == sorted(s1)
        for k in s0:
            assert torch.equal(s0[k], s1[k]), k
