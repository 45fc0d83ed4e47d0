"""``UFlowElboLoss`` with ``taylor_warp`` against ``arflow_tpu``'s in
float64 with the same injected draws (``tests/torch_elbo_util.py:
check_case``, at its 1e-10 bounds; the gaps measured are in
``test_torch_taylor_elbo.py``) for the ``lowrank`` posterior and a K = 3
``mixture`` with the model's weights and the drawn components injected,
which its Taylor path needs, in JAX too. ``diag`` and ``sparse`` are in
``test_torch_taylor_elbo.py``."""

import pytest

from torch_data_util import few_torch_threads  # noqa: F401  (fixture)
from torch_elbo_util import BASE, check_case

CASES = {
    "lowrank_c3_n3_occ_none": ({"approx": "lowrank", "columns": 3,
                                "n_samples": 3, "occ_type": "none"}, 31),
    "mixture_k3_n4": ({"approx": "mixture", "n_components": 3, "n_samples": 4,
                       "w_oof": 0.5, "given_weights": True}, 33),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_taylor_elbo_equals_jax_f64(name, monkeypatch):
    monkeypatch.delenv("ARFLOW_TAYLOR_WARP", raising=False)
    overrides, seed = CASES[name]
    check_case(dict(BASE, taylor_warp=True, **overrides), seed=seed)
