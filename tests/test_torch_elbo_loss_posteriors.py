"""The port's ``UFlowElboLoss`` against ``arflow_tpu``'s for the ``sparse``
(k = 1 and 3, with ``offdiag_reg``), ``mixture`` (K = 2, three samples,
uniform weights and the model's) and ``lowrank`` (3 columns) posteriors,
in float64 with the same injected draws: every term and map and the
gradients of the total (``tests/torch_elbo_util.py:check_case``). The
``diag`` posterior and the loss's other parts are in
``test_torch_elbo_loss.py``."""

import pytest

from torch_elbo_util import BASE, GMM, check_case
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

CASES = {
    "sparse_k1_n2_occ_none": {"approx": "sparse", "cov_supp": 1,
                              "n_samples": 2, "offdiag_reg": 0.5,
                              "occ_type": "none"},
    "sparse_k3_occ_mean_gmm": {"approx": "sparse", "cov_supp": 3,
                               "occ_type": "mean", "penalty_smooth": "gmm",
                               "penalty_smooth_pi": GMM["pi"],
                               "penalty_smooth_beta": GMM["beta"]},
    "mixture_k2_n3": {"approx": "mixture", "n_components": 2, "n_samples": 3,
                      "w_oof": 0.5, "w_occ": 0.3},
    # the model's weights in res["weights_fw"/"weights_bw"]
    "mixture_k2_weights": {"approx": "mixture", "n_components": 2,
                           "n_samples": 2, "occ_type": "none",
                           "given_weights": True},
    "lowrank_c3_n2": {"approx": "lowrank", "columns": 3, "n_samples": 2,
                      "penalty_smooth": "abs_robust_loss",
                      "data_penalty": ["charbonnier"]},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_elbo_loss_terms_and_gradients_f64(name, monkeypatch):
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    check_case(dict(BASE, **CASES[name]), seed=10 + sorted(CASES).index(name))
