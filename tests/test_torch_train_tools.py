"""``arflow_tpu_torch/tools/sanity_train.py`` and ``bf16_compare.py``
against the JAX package's tools, on the CPU at 2 steps, with no JAX
model compile: their pairs equal the JAX tools' bit for bit, their step
recipe (model, loss config, Adam) is the JAX tools' (read from the JAX
tools themselves, their model, loss and optimizer replaced by recorders),
and each prints what the JAX tool prints, with finite values.

The step's numerics are held elsewhere: ``MseLoss`` in every
parametrization by ``test_torch_mse.py`` and its trainer's steps by
``test_torch_mse_trainer.py``; ``PWCProbFlow`` with ``out_channels``
(2, 2, 0) in float64 by ``test_torch_uflow_prob.py`` and
``test_torch_uflow_prob_variants.py``, in bfloat16 by
``test_torch_bf16_prob.py``. The 300-step runs are ``chip_smoke.py``'s
``tools`` phase."""

import json
import re

import numpy as np
import pytest

import arflow_tpu.losses as jax_losses
import arflow_tpu.models.uflow_prob as jax_uflow_prob
import optax
from arflow_tpu.tools import bf16_compare as jax_bf16_compare
from arflow_tpu.tools import sanity_train as jax_sanity_train
from arflow_tpu_torch.tools import bf16_compare, sanity_train
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

# arflow_tpu/tools/bf16_compare.py:127-145
JAX_KEYS = {"metric", "steps", "final_epe_f32", "final_epe_bf16",
            "final_epe_delta", "epe_curve_f32", "epe_curve_bf16",
            "inference_flow_delta_px", "accept_threshold", "bf16_epe_safe"}


class Recipe(Exception):
    """Raised by the recorded ``optax.adam``: the JAX tool's recipe is
    read, nothing is traced further."""


@pytest.fixture
def jax_recipe(monkeypatch):
    """Replace the JAX tools' ``PWCProbFlow``, ``MseLoss`` and
    ``optax.adam`` by recorders; returns what they saw."""
    seen = {}

    class Model:
        def __init__(self, **kwargs):
            seen["model"] = kwargs

        def init(self, *args, **kwargs):
            return {"params": {}}

    def loss(cfg):
        seen["loss"] = dict(cfg)

    def adam(*args, **kwargs):
        seen["adam"] = (args, kwargs)
        raise Recipe

    monkeypatch.setattr(jax_uflow_prob, "PWCProbFlow", Model)
    monkeypatch.setattr(jax_losses, "MseLoss", loss)
    monkeypatch.setattr(optax, "adam", adam)
    return seen


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 4)])
def test_bf16_compare_pairs_equal_jax(seed, n):
    got = bf16_compare.make_pairs(np.random.RandomState(seed), n)
    want = jax_bf16_compare.make_pairs(np.random.RandomState(seed), n)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.float32 and a.shape == (n, 128, 160, 3)
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] == (3.0, 1.0)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_bf16_compare_recipe_is_jax(jax_recipe, dtype_name):
    """The JAX ``train_one``'s model, loss config and optimizer against the
    port's: ``PWCProbFlow(out_channels=(2, 2, 0), feature_norm=True)`` in
    the run's dtype, the same ``MseLoss`` config, Adam at 5e-4 with its
    default moments (torch's and optax's defaults agree)."""
    import jax.numpy as jnp
    import torch

    i1, i2, dxy = jax_bf16_compare.make_pairs(np.random.RandomState(0), 1)
    with pytest.raises(Recipe):
        jax_bf16_compare.train_one(dtype_name, jnp.asarray(i1), jnp.asarray(i2),
                                   None, dxy, 1)
    want_dtype = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    assert jax_recipe["model"] == {"out_channels": (2, 2, 0), "feature_norm": True,
                                   "dtype": want_dtype}
    assert jax_recipe["loss"] == bf16_compare.LOSS
    assert jax_recipe["adam"] == ((bf16_compare.LR,), {})
    model = bf16_compare.build_model(dtype_name, "cpu")
    assert model.out_channels == (2, 2, 0) and model.feature_norm
    assert not model.inv_cov and model.n_pyramids == 1 and not model.mixture_weights
    # float32 computes in the parameters' dtype (no cast)
    assert model.compute_dtype == (torch.bfloat16 if dtype_name == "bf16" else None)
    opt = torch.optim.Adam(model.parameters(), lr=bf16_compare.LR).defaults
    assert (opt["betas"], opt["eps"], opt["weight_decay"]) == ((0.9, 0.999), 1e-8, 0)


def test_sanity_train_recipe_and_pairs_are_jax(jax_recipe, monkeypatch):
    """The JAX ``sanity_train`` builds its inline pairs the way
    ``make_pairs`` draws them, and the port's takes ``make_pairs``; its
    model, loss config and Adam are ``bf16_compare``'s float32 ones."""
    import jax.numpy as jnp

    stacked = {}
    jnp_asarray = jnp.asarray

    def record(x, *a, **k):
        if getattr(x, "ndim", 0) == 4 and x.shape[-1] == 3:
            stacked[len(stacked)] = np.array(x)
        return jnp_asarray(x, *a, **k)

    monkeypatch.setattr(jnp, "asarray", record)
    with pytest.raises(Recipe):
        jax_sanity_train.main(steps=1, seed=0)
    want = jax_bf16_compare.make_pairs(np.random.RandomState(0), 8)
    np.testing.assert_array_equal(stacked[0], want[0])
    np.testing.assert_array_equal(stacked[1], want[1])
    assert jax_recipe["model"] == {"out_channels": (2, 2, 0), "feature_norm": True}
    assert jax_recipe["loss"] == sanity_train.LOSS
    assert jax_recipe["adam"] == ((sanity_train.LR,), {})


def test_sanity_train_two_steps_on_cpu(monkeypatch, capsys):
    """Two steps on the CPU print the JAX tool's lines (step 0 and the
    last) with finite values, on the pairs of ``make_pairs(RandomState(0),
    8)``, then the JAX tool's assert fails: 2 steps do not converge."""
    seen = []
    make_pairs = sanity_train.make_pairs
    monkeypatch.setattr(sanity_train, "make_pairs",
                        lambda rng, n: seen.append(make_pairs(rng, n)) or seen[-1])
    with pytest.raises(AssertionError, match="EPE did not converge"):
        sanity_train.main(steps=2, seed=0, device="cpu")
    want = jax_bf16_compare.make_pairs(np.random.RandomState(0), 8)
    np.testing.assert_array_equal(seen[0][0], want[0])
    np.testing.assert_array_equal(seen[0][1], want[1])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):
        m = re.fullmatch(r"step (\d+): loss (\S+) EPE (\S+)", line)
        assert m and int(m.group(1)) == i, line
        assert np.isfinite(float(m.group(2))) and np.isfinite(float(m.group(3)))


def test_bf16_compare_two_steps_on_cpu(capsys):
    """Both runs at 2 steps on the CPU: one JSON line with every key of the
    JAX tool's, finite values, curves of (step, EPE) at steps 0 and 1,
    the verdict as the JAX tool computes it."""
    bf16_compare.cli(["--steps", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == JAX_KEYS
    assert out["metric"] == "bf16_vs_f32_training" and out["steps"] == 2
    assert out["accept_threshold"] == 0.05
    for key in ("epe_curve_f32", "epe_curve_bf16"):
        assert [s for s, _ in out[key]] == [0, 1]
        assert np.isfinite([e for _, e in out[key]]).all()
    # Step 0's EPE is the shared initial weights' in each dtype.
    assert out["epe_curve_f32"][0][1] == pytest.approx(out["epe_curve_bf16"][0][1],
                                                       rel=0.05)
    for pname in ("f32_params", "bf16_params"):
        d = out["inference_flow_delta_px"][pname]
        assert np.isfinite([d["max_px"], d["mean_px"]]).all()
        assert 0 < d["mean_px"] <= d["max_px"]
    f32, bf16 = out["epe_curve_f32"][-1][1], out["epe_curve_bf16"][-1][1]
    assert out["final_epe_f32"] == round(f32, 4)
    assert out["final_epe_delta"] == round(abs(bf16 - f32), 4)
    assert out["bf16_epe_safe"] == (bf16 <= f32 + 0.05)


def test_tools_refuse_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (lambda: sanity_train.cli(["--steps", "1"]),
                lambda: bf16_compare.cli(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            run()
