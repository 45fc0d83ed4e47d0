"""The port's ``torch.export`` artifacts for ``uflow_prob`` with the
``mixture`` entropy (two pyramids, ``chairs_uflow_elbo_mixture.json``'s
model without its weights net) at 64x96 b1 on the CPU: the monolithic
artifact, each loaded output equal to the eager port model (bit for bit)
and within the bounds of ``tests/test_torch_serving.py`` of the JAX
package's ``export_inference`` artifact exported for ``cpu`` from the same
weights.

Two pyramids make a long graph (100 Monte-Carlo draws of the entropy),
so the monolithic and the streaming artifact have a file each. The
artifact hashes its draws in the program (``utils/gmm.py:hash_draws``), the
eager model's entropy is computed with the same draws injected, and JAX
draws from ``PRNGKey(0)``: the JAX artifact's entropy is held to the
port's ``extract_uv_entropy`` of the eager outputs with JAX's draws
injected. The artifact holds the weights and no draw. The streaming
artifact: ``test_torch_serving_export_mixture_stream.py``."""

import io
import os

import pytest
import torch

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_export_util import (
    artifacts,
    check_monolithic,
    jax_mixture_draws,
)
from torch_port_util import H, W, few_torch_threads  # noqa: F401  (fixture)

# The serialized graph of the monolithic mixture program beside its
# weights (measured: 4,713,176 bytes at 64x96 b1, 7,490 more at 128x192).
GRAPH_BYTES = 6 * 2 ** 20


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    return artifacts("mixture", tmp_path_factory.mktemp("m"), False)


def test_monolithic_matches_eager_and_jax(mono):
    from arflow_tpu_torch.training.entropy import extract_uv_entropy

    cfg, sd, path, jax_path = mono

    def jax_ent(res):
        flows = res["flows_fw"]
        draws = jax_mixture_draws(cfg.loss.n_components, flows[0].shape[:3])
        return extract_uv_entropy(flows, cfg.loss, res, draws=draws)

    check_monolithic(cfg, sd, path, jax_path, jax_ent=jax_ent)


def held_bytes(ep):
    """Bytes of every tensor that the exported program ``ep`` keeps."""
    held = list(ep.state_dict.values()) + [
        t for t in ep.constants.values() if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in held)


def test_artifact_holds_the_weights_and_no_draws(mono, tmp_path):
    """Every tensor the program keeps is a weight of the model, and the
    file is the weights plus a graph that does not grow with H x W: the
    artifact at 4x the pixels has the same size, where 100 stored draws
    would add 100 x 8 x 3 x H x W bytes."""
    from arflow_tpu_torch.serving import export

    cfg, sd, path, _ = mono
    weights = sum(t.numel() * t.element_size() for t in sd.values())
    _, payload = export._read(path)
    assert held_bytes(torch.export.load(io.BytesIO(payload))) == weights
    size = os.path.getsize(path)
    assert size <= weights + GRAPH_BYTES, (size, weights)

    big = str(tmp_path / "big.afx")
    ep, meta = export.export_inference(cfg, sd, 1, (2 * H, 2 * W),
                                       device="cpu")
    export.save_artifact(big, ep, meta)
    assert held_bytes(ep) == weights
    grown = os.path.getsize(big) - size
    assert abs(grown) < 2 ** 16 < 100 * 8 * 3 * H * W, grown
