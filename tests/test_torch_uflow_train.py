"""``PWCFlow(train=True)``: level dropout on the full-width model at
1x64x96, float64. The comparison with the JAX model in training mode, flows
and parameter gradients, is in ``test_torch_uflow_train_grads.py``.

- p = 0: the training forward is the inference forward.
- A fixed ``torch.Generator``: two runs agree, and a ``with_bk`` forward
  takes 10 draws from it (4 levels and the refinement, per direction).
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model, uflow_state_dict_from_jax
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    frames,
    few_torch_threads,
    jax_params,
)


def _port(params, level_dropout):
    model = get_model(Config(dict(CFG, level_dropout=level_dropout)),
                      device="cpu")
    model.load_state_dict(uflow_state_dict_from_jax(params), strict=True)
    return model.to(torch.float64)


def test_train_forward_at_p0_is_inference(jax_params):
    img1, img2 = (torch.from_numpy(x) for x in frames(2, seed=4))
    model = _port(jax_params, 0.0)
    with torch.no_grad():
        ref = model(img1, img2, with_bk=True)
        ours = model(img1, img2, with_bk=True, train=True)
    for key in ("flows_fw", "flows_bw"):
        for a, b in zip(ours[key], ref[key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_generator_draws(jax_params):
    img1, img2 = (torch.from_numpy(x) for x in frames(2, seed=5))
    model = _port(jax_params, 0.5)
    with pytest.raises(ValueError, match="Generator"):
        model(img1, img2, train=True)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            runs.append(model(img1, img2, with_bk=True, train=True,
                              generator=gen))
    for key in ("flows_fw", "flows_bw"):
        for a, b in zip(runs[0][key], runs[1][key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # 5 draws per direction: the generator stands where 10 scalar draws
    # from the same seed leave it.
    want = torch.Generator().manual_seed(3)
    for _ in range(10):
        torch.rand((), generator=want)
    assert torch.equal(gen.get_state(), want.get_state())
