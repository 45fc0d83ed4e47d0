"""The port's ``torch.export`` artifacts for ``uflow_prob`` with the
``diag`` entropy (``sintel_uflow_elbo_inference.json``'s) at 64x96 b1 on the CPU: monolithic and streaming, each loaded
output equal to the eager port model and engine (bit for bit) and within the bounds
of ``tests/test_torch_serving.py`` of the JAX package's artifacts exported
for ``cpu`` from the same weights."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from torch_export_util import (
    artifacts,
    check_monolithic,
    check_streaming,
)
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    return artifacts("diag", tmp_path_factory.mktemp("mono"), False)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    return artifacts("diag", tmp_path_factory.mktemp("stream"), True)


def test_monolithic_matches_eager_and_jax(mono):
    check_monolithic(*mono)


def test_streaming_matches_engine_and_jax(stream):
    check_streaming(*stream)
