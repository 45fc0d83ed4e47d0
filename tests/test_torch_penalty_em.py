"""The port's GMM penalty fit against ``arflow_tpu.tools.penalty_em``: the
EM update in float64, ``fwhm_scale``, ``collect_residuals`` on a small
``Chairs2``-format directory (both penalties), and ``fit_penalty_cli``'s
printed arrays. The JAX package's own ``tests/test_penalty_em.py`` needs
the reference oracle; these hold the port to the JAX tool directly.

The JAX side decodes PNGs with PIL (``arflow_tpu.native`` off), as the
port does."""

import json

import numpy as np
import pytest
import torch

import arflow_tpu.native
from arflow_tpu.cli import fit_penalty_cli as jax_fit_penalty_cli
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.data import DataLoader as JaxDataLoader
from arflow_tpu.data import get_dataset as jax_get_dataset
from arflow_tpu.tools import penalty_em as jax_em
from arflow_tpu_torch import Config
from arflow_tpu_torch.cli import fit_penalty_cli
from arflow_tpu_torch.data import DataLoader, get_dataset
from arflow_tpu_torch.tools import penalty_em
from arflow_tpu_torch.utils.flow_io import write_flo
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

H, W = 64, 96
LOSS = {"edge_constant": 150.0, "edge_asymp": 0.01, "data_loss": ["census"]}


@pytest.fixture(autouse=True)
def pil_on_both_sides(monkeypatch):
    monkeypatch.setattr(arflow_tpu.native, "available", lambda: False)


def _samples(seed, n=5000):
    rs = np.random.RandomState(seed)
    # A scale mixture: most residuals small, a tail of large ones.
    scale = np.where(rs.rand(n) < 0.8, 0.05, 1.5)
    return rs.randn(n) * scale


def test_em_updates_match_jax_f64():
    x0 = _samples(0)
    x1 = np.random.RandomState(1).rand(x0.size) + 0.5
    init = [0.001, 0.01, 0.1, 1.0, 10.0]
    ours = penalty_em.EM(k=5, init_vars=init, device="cpu")
    theirs = jax_em.EM(k=5, init_vars=init)
    for weights in (None, x1, x1):
        obj = ours.update(x0, weights)
        obj_j = theirs.update(x0, None if weights is None else weights)
        # float64 on both sides; only summation orders differ (measured:
        # objectives 5.5e-15 apart relative, states 1.3e-15).
        assert obj == pytest.approx(obj_j, rel=1e-12)
        for name in ("pi", "mu", "beta", "alpha_bar"):
            got = getattr(ours.state, name)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(theirs.state, name)),
                                       rtol=1e-12, atol=0, err_msg=name)


def test_fwhm_scale_and_widths_match_jax():
    pi = np.array([0.5, 0.3, 0.2])
    beta = np.array([100.0, 10.0, 0.5])
    for ref in (jax_em.robust_l1_fwhm(), jax_em.abs_robust_loss_fwhm()):
        assert penalty_em.fwhm_scale(pi, np.zeros(3), beta, ref) == \
            jax_em.fwhm_scale(pi, np.zeros(3), beta, ref)
    assert penalty_em.robust_l1_fwhm() == jax_em.robust_l1_fwhm()
    assert penalty_em.abs_robust_loss_fwhm() == jax_em.abs_robust_loss_fwhm()
    x = np.linspace(-2, 2, 9)
    np.testing.assert_array_equal(penalty_em.gaussian_mixture(x, pi, 0 * pi, beta),
                                  jax_em.gaussian_mixture(x, pi, 0 * pi, beta))


def _chairs2(root, n=4):
    """``n`` pairs in ``Chairs2``'s ``val/`` layout: smooth textures, the
    second moved by a whole shift, with forward and backward flow."""
    from PIL import Image

    val = root / "val"
    val.mkdir(parents=True)
    rs = np.random.RandomState(3)
    for fid in range(n):
        dy, dx = rs.randint(-3, 4, size=2)
        tex = np.kron(rs.rand(H // 8 + 2, W // 8 + 2, 3), np.ones((8, 8, 1)))
        tex = np.clip(tex + 0.05 * rs.randn(*tex.shape), 0, 1)
        img1 = tex[4:4 + H, 4:4 + W]
        img2 = tex[4 - dy:4 - dy + H, 4 - dx:4 - dx + W]
        for i, img in enumerate((img1, img2)):
            Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
                val / f"{fid:07d}-img_{i}.png")
        flow = np.tile(np.float32([dx, dy]), (H, W, 1))
        flow += 0.3 * rs.randn(H, W, 2).astype(np.float32)
        write_flo(str(val / f"{fid:07d}-flow_01.flo"), flow)
        write_flo(str(val / f"{fid:07d}-flow_10.flo"), -flow)
    return root


def _config(root):
    return {"data": [{"name": "Chairs2", "type": "valid", "n_frames": 2,
                      "split": "valid", "root_chairs": str(root)}],
            "loss": LOSS, "train": {"batch_size": 2, "workers": 1}}


# float32 residuals through different warps and resizes. Smooth: flow
# differences of the same downsampled flows (measured: at most 1.8e-7 on
# values up to 0.20). Data: census terms of warped images, which amplify
# the float32 rounding of the bilinear warp (measured: median 3.8e-5, at
# most 2.08e-3, on values up to 28.0).
RESIDUAL_ATOL = {"smooth": 1e-6, "data": 5e-3}


@pytest.mark.parametrize("penalty", ["smooth", "data"])
def test_collect_residuals_matches_jax(tmp_path, penalty):
    cfg = _config(_chairs2(tmp_path))
    _, valid = get_dataset(Config(cfg))
    _, valid_j = jax_get_dataset(JaxConfig(cfg))
    loader = DataLoader(valid[0], batch_size=2, num_workers=1)
    loader_j = JaxDataLoader(valid_j[0], batch_size=2, num_workers=1)
    ours = penalty_em.collect_residuals(loader, Config(LOSS), penalty=penalty,
                                        subsample=0.5, device="cpu")
    theirs = jax_em.collect_residuals(loader_j, JaxConfig(LOSS), penalty=penalty,
                                      subsample=0.5)
    # The same pixels kept (the same draws, in the JAX order), and their
    # values within the bounds above.
    assert ours.shape == theirs.shape and ours.size > 1000
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=RESIDUAL_ATOL[penalty])


def test_fit_penalty_cli_prints_the_jax_arrays(tmp_path, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_config(_chairs2(tmp_path / "chairs"))))
    argv = ["-c", str(cfg_path), "--penalty", "smooth", "--k", "4",
            "--n_iter", "5", "--init_vars", "0.01", "0.1", "1", "10"]
    out = fit_penalty_cli(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    jax_fit_penalty_cli(argv)
    theirs = capsys.readouterr().out.splitlines()
    assert len(ours) == len(theirs) == 1 + 5 + 4
    assert ours[0] == theirs[0]  # the same number of samples
    got = {line.split(":")[0]: line for line in ours}
    want = {line.split(":")[0]: line for line in theirs}
    for key in ("Pi", "Beta", "Beta scaled"):
        a = np.array(json.loads(got[key].split(":", 1)[1]))
        b = np.array(json.loads(want[key].split(":", 1)[1]))
        # float64 EM on float32 residuals that differ by rounding (above)
        # (measured: 1.5e-7 relative).
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert np.isclose(out["pi"].sum(), 1.0) and np.isfinite(out["scale"])
