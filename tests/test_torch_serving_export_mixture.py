"""The port's ``torch.export`` artifacts for ``uflow_prob`` with the
``mixture`` entropy (two pyramids, ``chairs_uflow_elbo_mixture.json``'s model without its weights net) at 64x96 b1 on the CPU: the monolithic artifact, each loaded
output equal to the eager port model (bit for bit) and within the bounds
of ``tests/test_torch_serving.py`` of the JAX package's ``export_inference`` artifact exported
for ``cpu`` from the same weights.

Two pyramids make a long graph (100 Monte-Carlo draws of the entropy),
so the monolithic and the streaming artifact have a file each. The port
draws the samples from its own generator seeded 0 and JAX from
``PRNGKey(0)``: the JAX artifact's entropy is held to the port's
``extract_uv_entropy`` of the eager outputs with JAX's draws injected. The streaming artifact: ``test_torch_serving_export_mixture_stream.py``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_export_util import (
    artifacts,
    check_monolithic,
    jax_mixture_draws,
)
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)


def test_monolithic_matches_eager_and_jax(tmp_path_factory):
    from arflow_tpu_torch.training.entropy import extract_uv_entropy

    cfg, sd, mono, jax_mono = artifacts("mixture", tmp_path_factory.mktemp("m"),
                                        False)

    def jax_ent(res):
        flows = res["flows_fw"]
        draws = jax_mixture_draws(cfg.loss.n_components, flows[0].shape[:3])
        return extract_uv_entropy(flows, cfg.loss, res, draws=draws)

    check_monolithic(cfg, sd, mono, jax_mono, jax_ent=jax_ent)
