"""The port's entropy maps (``training/entropy.py:extract_uv_entropy``, all
four approximations) and Gaussian-mixture helpers (``utils/gmm.py``)
against ``arflow_tpu``'s in float64, on random model-shaped outputs; the
Monte-Carlo mixture entropy with JAX's draws injected."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.training.entropy import extract_uv_entropy as jax_extract
from arflow_tpu.utils import gmm as jax_gmm
from arflow_tpu_torch import Config
from arflow_tpu_torch.training.entropy import extract_uv_entropy
from arflow_tpu_torch.utils import gmm
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

B, H2, W2 = 2, 8, 12
H, W = 4 * H2, 4 * W2
N_SAMPLES = 100  # what extract_uv_entropy draws
# The same float64 formulas; exp, log and the sums over pixels, components
# and samples may round differently (measured: at most 3.6e-15 on values up
# to 8.1; diag and sparse without inv_cov are copies, equal bit for bit).
ATOL = 1e-12


def model_outputs(seed, ch0, ch2, log_diag2=None):
    """[full, 1/2, 1/4, ...] NHWC float64 with ``ch0`` channels at full and
    ``ch2`` at 1/4 resolution; ``log_diag2`` overrides channels 2:4 at 1/4."""
    rs = np.random.RandomState(seed)
    f0 = rs.randn(B, H, W, ch0)
    f2 = rs.randn(B, H2, W2, ch2)
    if log_diag2 is not None:
        f2[..., 2:4] = log_diag2
    dummy = np.zeros((B, 2, 2, 2))
    return [f0, dummy, f2, dummy, dummy, dummy]


def jax_draws(weights, shape, n_samples, key):
    """The draws ``arflow_tpu.utils.gmm.mixture_entropy`` makes from
    ``key``: per sample a component per image and standard normals."""
    z, eps = [], []
    for k in jax.random.split(key, n_samples):
        kz, ke = jax.random.split(k)
        z.append(np.asarray(jax.random.categorical(kz, jnp.log(weights),
                                                   shape=(shape[0],))))
        eps.append(np.asarray(jax.random.normal(ke, (*shape[:3], 2),
                                                jnp.float64)))
    return {"z": torch.from_numpy(np.stack(z)).long(),
            "eps": torch.from_numpy(np.stack(eps))}


@pytest.mark.parametrize("approx, cfg, ch0, ch2", [
    ("diag", {}, 4, 4),
    ("sparse", {"inv_cov": False}, 34, 34),
    ("sparse", {"inv_cov": True}, 10, 10),
    ("lowrank", {"columns": 15}, 32, 32),
])
def test_entropy_matches_jax(approx, cfg, ch0, ch2):
    # inv_cov: log-diagonal about 1 (a diagonal of e), couplings ~1
    log_diag2 = (1.0 + 0.1 * np.random.RandomState(9).randn(B, H2, W2, 2)
                 if cfg.get("inv_cov") else None)
    flows = model_outputs(len(approx) + ch0, ch0, ch2, log_diag2)
    loss = {"approx": approx, **cfg}
    ent = extract_uv_entropy([torch.from_numpy(f) for f in flows], Config(loss))
    ent_j = np.asarray(jax_extract([jnp.asarray(f) for f in flows],
                                   JaxConfig(loss)))
    assert tuple(ent.shape) == ent_j.shape == (B, H, W, 2)
    assert np.isfinite(ent_j).all()
    np.testing.assert_allclose(ent.numpy(), ent_j, rtol=0, atol=ATOL)


def test_mixture_entropy_matches_jax_with_its_draws():
    k = 2
    flows = model_outputs(5, 4 * k, 4 * k)
    loss = {"approx": "mixture", "n_components": k}
    key = jax.random.PRNGKey(0)
    weights = jnp.ones((B, k), jnp.float64) / k
    draws = jax_draws(weights, (B, H, W), N_SAMPLES, key)
    ent = extract_uv_entropy([torch.from_numpy(f) for f in flows], Config(loss),
                             draws=draws)
    ent_j = np.asarray(jax_extract([jnp.asarray(f) for f in flows],
                                   JaxConfig(loss), rng=key))
    assert tuple(ent.shape) == ent_j.shape == (B, H, W, 2)
    np.testing.assert_allclose(ent.numpy(), ent_j, rtol=0, atol=ATOL)
    # with predicted weights, from the res dict
    w = np.array([[0.3, 0.7], [0.9, 0.1]])
    draws = jax_draws(jnp.asarray(w), (B, H, W), N_SAMPLES, key)
    ent = extract_uv_entropy([torch.from_numpy(f) for f in flows], Config(loss),
                             {"weights_fw": torch.from_numpy(w)}, draws=draws)
    ent_j = np.asarray(jax_extract([jnp.asarray(f) for f in flows],
                                   JaxConfig(loss),
                                   {"weights_fw": jnp.asarray(w)}, rng=key))
    np.testing.assert_allclose(ent.numpy(), ent_j, rtol=0, atol=ATOL)


def test_mixture_entropy_draws_from_a_generator():
    """Without injected draws: reproducible from the seed, and the
    Monte-Carlo mean near JAX's own draws (different numbers, same law)."""
    k = 2
    flows = [torch.from_numpy(f) for f in model_outputs(6, 4 * k, 4 * k)]
    loss = Config({"approx": "mixture", "n_components": k})
    a = extract_uv_entropy(flows, loss, generator=torch.Generator().manual_seed(0))
    b = extract_uv_entropy(flows, loss)  # a generator seeded 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ent_j = np.asarray(jax_extract([jnp.asarray(f.numpy()) for f in flows],
                                   JaxConfig(dict(loss))))
    # 100 samples of -log p per pixel: the two means differ by MC noise,
    # whose mean over the maps is far smaller than the per-pixel spread
    assert abs(float(a.mean()) - float(ent_j.mean())) < 0.05 * float(a.std())


@pytest.mark.parametrize("per_pixel", [True, False])
def test_gaussian_mixture_log_pdf_matches_jax(per_pixel):
    rs = np.random.RandomState(4)
    k, s = 3, 2
    mean = rs.randn(B, H2, W2, 2 * k)
    log_std = 0.3 * rs.randn(B, H2, W2, 2 * k)
    weights = rs.dirichlet(np.ones(k), size=B)
    flow = rs.randn(s * B, H2, W2, 2)
    ours = gmm.gaussian_mixture_log_pdf(
        *(torch.from_numpy(t) for t in (flow, mean, log_std, weights)),
        per_pixel=per_pixel)
    theirs = np.asarray(jax_gmm.gaussian_mixture_log_pdf(
        *(jnp.asarray(t) for t in (flow, mean, log_std, weights)),
        per_pixel=per_pixel))
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=ATOL)
    x = torch.from_numpy(rs.randn(4, 5))
    np.testing.assert_allclose(
        gmm.log_sum_exp(x, dim=1).numpy(),
        np.asarray(jax_gmm.log_sum_exp(jnp.asarray(x.numpy()), axis=1)),
        rtol=0, atol=ATOL)
