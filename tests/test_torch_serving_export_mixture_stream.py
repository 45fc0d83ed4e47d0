"""The port's ``torch.export`` artifacts for ``uflow_prob`` with the
``mixture`` entropy (two pyramids, ``chairs_uflow_elbo_mixture.json``'s model without its weights net) at 64x96 b1 on the CPU: the streaming artifact, each loaded
output equal to the eager port engine (bit for bit; the entropy with the
artifact's hashed draws injected) and within the bounds of
``tests/test_torch_serving.py`` of the JAX package's ``export_streaming``
artifact exported for ``cpu`` from the same weights. The entropies are not
held to JAX's here, whose Monte-Carlo draws differ
(``test_torch_serving_export_mixture.py`` holds the monolithic one with
JAX's draws injected)."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_export_util import (
    artifacts,
    check_streaming,
)
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)


def test_streaming_matches_engine_and_jax(tmp_path_factory):
    check_streaming(*artifacts("mixture", tmp_path_factory.mktemp("s"), True),
                    jax_entropy=False)
