"""The mixture's Taylor warp in the port against ``arflow_tpu``'s, in
float64 on the CPU: the bidirectional data term with a K = 3 mixture's
means and the drawn components injected (``test_torch_taylor_warp.py``'s
``check_bidir``, at its bounds), and the convergence order of
``tests/test_taylor_warp.py``'s mixture tests on the port. The mixture
ELBO loss with ``taylor_warp`` is in
``test_torch_taylor_elbo_posteriors.py``."""

import numpy as np
import pytest
import torch

from test_torch_taylor_warp import check_bidir, data_terms, smooth_images
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


@pytest.mark.parametrize("occ", ["sample", "none"])
def test_bidir_taylor_mixture_equals_jax(occ, monkeypatch):
    """K = 3: one gather per component and direction; each sample reads
    the taps of its drawn component. (The JAX 'mean' occlusion takes
    2-channel means only.)"""
    check_bidir(3, occ, monkeypatch)


def test_taylor_mixture_converges_to_exact(monkeypatch):
    """``tests/test_taylor_warp.py:test_taylor_mixture_converges_to_exact``
    on the port: two components 12 px apart at full resolution, each
    sample drawn around its component; 10x less perturbation shrinks the
    gap at least 5x, to under 1% of the term (the JAX test's bounds;
    measured here 16x, to 0.28%). With two identical
    components the mixture path equals the unimodal one
    (``test_taylor_mixture_identical_components_match_unimodal``, held at
    1e-6 in float32 there; here float64, measured 3.8e-13 on terms of
    order 1, where the means' upsampling rounds at other widths, held at
    1e-10 as the data term against JAX)."""
    rs = np.random.RandomState(1)
    b, h, w, n, k = 2, 32, 40, 4, 2
    im1, im2 = smooth_images(rs, b, h, w), smooth_images(rs, b, h, w)
    h2, w2 = h // 4, w // 4
    mean12 = np.concatenate([rs.randn(b, h2, w2, 2) * 0.5,
                             rs.randn(b, h2, w2, 2) * 0.5 + 3.0], axis=-1)
    mean21 = np.concatenate([rs.randn(b, h2, w2, 2) * 0.5,
                             rs.randn(b, h2, w2, 2) * 0.5 - 3.0], axis=-1)
    z12, z21 = rs.randint(0, k, (b, n)), rs.randint(0, k, (b, n))

    def around(mean, z, eps):
        sel = np.stack([mean[i, ..., 2 * z[i, s]:2 * z[i, s] + 2]
                        for s in range(n) for i in range(b)])
        return torch.from_numpy(sel + eps * rs.randn(n * b, h2, w2, 2))

    errs = []
    kw = {"mean12_2": torch.from_numpy(mean12), "mean21_2": torch.from_numpy(mean21),
          "n_rep": n, "z12": torch.from_numpy(z12), "z21": torch.from_numpy(z21)}
    for eps in (0.3, 0.03):
        args = (im1, im2, around(mean12, z12, eps), around(mean21, z21, eps), "sample")
        exact = data_terms(monkeypatch, "0", *args, **kw)
        taylor = data_terms(monkeypatch, "1", *args, **kw)
        errs.append(float((taylor - exact).abs().mean()))
        scale = float(exact.abs().mean())
    assert errs[1] < errs[0] * 0.2, errs
    assert errs[1] < 0.01 * scale, (errs, scale)

    m12, m21 = (torch.from_numpy(rs.randn(b, h2, w2, 2) * 0.5) for _ in range(2))
    flows = (m12.repeat(n, 1, 1, 1) + 0.05, m21.repeat(n, 1, 1, 1) - 0.05)
    args = (im1, im2, *flows, "none")
    uni = data_terms(monkeypatch, "1", *args, mean12_2=m12, mean21_2=m21, n_rep=n)
    mix = data_terms(monkeypatch, "1", *args, mean12_2=torch.cat([m12, m12], -1),
                     mean21_2=torch.cat([m21, m21], -1), n_rep=n,
                     z12=torch.from_numpy(z12), z21=torch.from_numpy(z21))
    torch.testing.assert_close(mix, uni, rtol=0, atol=1e-10)
