"""``PWCLiteUflow(train=True)``'s level dropout against ``arflow_tpu``'s
at the published widths on a 2x64x128 pair, in float64 with the JAX
package's TPU relayouts off, the same uniform draws injected on both
sides, every output level of both directions."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import (  # noqa: F401  (fixture: lite_env)
    draw_params,
    images,
    jax_forward,
    level_gaps,
    lite_env,
    port_model,
    run_port,
)

# As test_torch_pwclite_prob_uflow.py (measured: at most 2.0e-14 px on
# flows up to 13.4).
ATOL = 1e-10
P = 0.5


def test_pwclite_uflow_level_dropout_matches_jax(lite_env, monkeypatch):
    """``train=True``: one draw per level (4) and one for the context, per
    direction, forward first; each draw keeps (u > p) or drops the level's
    flow residual and features. The same draws go to JAX's
    ``jax.random.uniform`` and the port's ``torch.rand``."""
    cfg = {"type": "pwclite_uflow", "n_frames": 2, "level_dropout": P,
           "feature_norm": True}
    params = draw_params(cfg, seed=8)
    imgs = images(2, seed=6)
    draws = [np.float64(u) for u in
             (0.9, 0.2, 0.7, 0.3, 0.6, 0.1, 0.8, 0.4, 0.95, 0.05)]
    queue = list(draws)

    def uniform(key, shape=(), dtype=None, *args, **kwargs):
        assert tuple(shape) == ()
        return jnp.asarray(queue.pop(0), jnp.float64)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    res_j = jax_forward(cfg, params, imgs, with_bk=True, train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    assert not queue

    model = port_model(cfg, params)
    queue = list(draws)

    def rand(shape, generator=None, device=None, **kwargs):
        assert generator is not None and tuple(shape) == (1,)
        return torch.tensor([queue.pop(0)], dtype=torch.float64)

    monkeypatch.setattr(torch, "rand", rand)
    res_t = run_port(model, imgs, with_bk=True, train=True,
                     generator=torch.Generator())
    monkeypatch.undo()
    assert not queue
    for key in ("flows_fw", "flows_bw"):
        assert len(res_t[key]) == 6
        assert max(level_gaps(res_t[key], res_j[key])) < ATOL
    # the drops reached the outputs: the same weights without dropout differ
    plain = run_port(model, imgs, with_bk=True)
    assert max(level_gaps(plain["flows_fw"], res_j["flows_fw"])) > 1e-3
    with pytest.raises(ValueError, match="Generator"):
        run_port(model, imgs, train=True)
