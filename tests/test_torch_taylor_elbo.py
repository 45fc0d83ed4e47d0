"""The port's ``UFlowElboLoss`` with ``taylor_warp`` against
``arflow_tpu``'s, in float64 with the same injected draws, for the
``diag`` and ``sparse`` posteriors (``tests/torch_elbo_util.py:check_case``:
every term and map and the gradients of the total to both directions'
outputs, at its 1e-10 bounds; ``lowrank`` and ``mixture``, whose
injected components its Taylor path needs in JAX too, are in
``test_torch_taylor_elbo_posteriors.py``); and the environment variable
overriding the config both ways.

The Taylor warp needs several samples, so each case draws two or more.
Measured over these cases and the other two posteriors': the terms
within 2.3e-15 relative, the maps 3.1e-15, the output gradients 1.5e-12
of their largest element, inside ``check_case``'s 1e-10 (set from the
exact warp's gaps, 1.8e-15, 3.6e-15 and 8.0e-12)."""

import numpy as np
import pytest

from torch_elbo_util import BASE, check_case, inputs, port_loss
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

CASES = {
    "diag_n4_occ_mean": ({"n_samples": 4, "occ_type": "mean", "w_occ": 0.3}, 30),
    "sparse_k1_n2": ({"approx": "sparse", "cov_supp": 1, "n_samples": 2,
                      "offdiag_reg": 0.5}, 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_taylor_elbo_equals_jax_f64(name, monkeypatch):
    monkeypatch.delenv("ARFLOW_TAYLOR_WARP", raising=False)
    overrides, seed = CASES[name]
    check_case(dict(BASE, taylor_warp=True, **overrides), seed=seed)


def test_environment_overrides_the_config(monkeypatch):
    """``ARFLOW_TAYLOR_WARP=1`` turns the Taylor warp on under
    ``taylor_warp: false`` and ``=0`` off under ``true``, read at each
    call: each loss equals, bit for bit, the one whose config asks for
    what the variable forces. Unset, the config decides, and the two
    warps differ."""
    cfg = dict(BASE, n_samples=3, occ_type="mean")
    args = inputs(cfg, seed=7)

    def total(taylor, env):
        if env is None:
            monkeypatch.delenv("ARFLOW_TAYLOR_WARP", raising=False)
        else:
            monkeypatch.setenv("ARFLOW_TAYLOR_WARP", env)
        out, grads = port_loss(dict(cfg, taylor_warp=taylor), *args)
        return float(out["total"].detach()), [g.numpy() for g in grads]

    exact, taylor = total(False, None), total(True, None)
    assert exact[0] != taylor[0]
    for want, got in ((taylor, total(False, "1")), (exact, total(True, "0"))):
        assert got[0] == want[0]
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w)
