"""The port's PWCProbFlow with the int ``out_channels`` schemas and with
two pyramids, and ComponentNet, against ``arflow_tpu`` at full default
widths on a 1x64x96 pair, in float64 with the JAX package's TPU relayouts
off (as ``test_torch_uflow_prob.py``, split from it to keep each file
short)."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

from arflow_tpu_torch.models import (
    ComponentNet,
    PWCProbFlow,
    component_state_dict_from_jax,
    uflow_prob_state_dict_from_jax,
)
from torch_port_util import few_torch_threads  # noqa: F401
from torch_prob_util import ATOL, check_channels, forward_gap


@pytest.mark.parametrize("case, out_channels", [
    ("int4", (2, 2, 0)), ("int8_inv", (2, 6, 0)), ("two_pyramids", (2, 2, 0))])
def test_pwcprobflow_variants_match_jax_f64_gates_off(case, out_channels,
                                                      monkeypatch):
    gap, model, flows = forward_gap(case, uflow_prob_state_dict_from_jax, 1,
                                    monkeypatch)
    assert isinstance(model, PWCProbFlow)
    assert model.out_channels == out_channels
    assert gap < ATOL
    check_channels(model, flows)


def test_component_net_matches_jax_f64_gates_off(monkeypatch):
    # The JAX ComponentNet needs with_bk=True (it reads flows_bw
    # unconditionally); the port's gives the forward half without it.
    gap, model, flows = forward_gap("component", component_state_dict_from_jax,
                                    2, monkeypatch)
    assert isinstance(model, ComponentNet)
    assert gap < ATOL
    assert [f.shape[-1] for f in flows] == [8] * 6
