"""The cost volume as the ``torch.library`` ops ``arflow::cost_volume`` and
``arflow::cost_volume_bwd``: their registrations (``opcheck``), gradients
in float64 through the op, a model's forward and backward through the op
against the autograd Function the port had before (the same plain
versions on the CPU, so equal bit for bit), and the CUDA implementations,
which launch a kernel or raise and never take the plain path."""

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models import uflow as uflow_module
from arflow_tpu_torch.ops.cost_volume import compute_cost_volume
from arflow_tpu_torch.ops.cuda import COST_VOLUME, COST_VOLUME_BWD
from arflow_tpu_torch.ops.cuda.cost_volume import (
    compute_cost_volume_reference,
    cost_volume_grad_reference,
)
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

CV = torch.ops.arflow.cost_volume.default
CV_BWD = torch.ops.arflow.cost_volume_bwd.default


def _pair(shape, seed, dtype=torch.float64, grad=False):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(*shape)).to(dtype).requires_grad_(grad)
                 for _ in range(2))


@pytest.mark.parametrize("shape,md", [((1, 3, 5, 6), 2), ((2, 8, 9, 11), 4),
                                      ((1, 32, 2, 3), 4)])
def test_opcheck_cost_volume(shape, md):
    """Schema, fake (meta) shapes, the autograd registration against the
    fake, and dynamic shapes under AOT dispatch."""
    f1, f2 = _pair(shape, 0, grad=True)
    torch.library.opcheck(CV, (f1, f2, md))


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
def test_opcheck_cost_volume_bwd(need):
    f1, f2 = _pair((2, 4, 6, 7), 1)
    g = torch.randn((2, 25, 6, 7), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    torch.library.opcheck(CV_BWD, (g, f1, f2, 2, *need))
    gf1, gf2 = CV_BWD(g, f1, f2, 2, *need)
    r1, r2 = cost_volume_grad_reference(g, f1, f2, 2)
    for got, want, asked in ((gf1, r1, need[0]), (gf2, r2, need[1])):
        if asked:  # the plain version itself on the CPU
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            assert got.shape == (0,)


@pytest.mark.parametrize("md", [1, 3])
def test_gradcheck_through_the_op_f64(md):
    f1, f2 = _pair((1, 3, 6, 7), 3, grad=True)
    assert torch.autograd.gradcheck(lambda a, b: CV(a, b, md), (f1, f2))


def test_no_backward_work_for_an_input_without_grad(monkeypatch):
    """Only f1 needs a gradient: the backward op is asked for grad_f1 alone;
    neither needs one: the backward op is not called."""
    calls = []
    real = torch.ops.arflow.cost_volume_bwd

    class Spy:
        def __call__(self, *args):
            calls.append(args[-2:])
            return real(*args)

    monkeypatch.setattr(torch.ops.arflow, "cost_volume_bwd", Spy())
    f1, f2 = _pair((1, 4, 5, 6), 4)
    a = f1.clone().requires_grad_()
    (compute_cost_volume(a, f2, 2) ** 2).sum().backward()
    assert calls == [(True, False)] and a.grad is not None
    b = f2.clone().requires_grad_()
    out = compute_cost_volume(f1, b, 2)
    torch.autograd.grad((out * 0).sum(), b)
    assert calls[-1] == (False, True)


class _PlainFunction(torch.autograd.Function):
    """The autograd Function the port dispatched through before the op, on
    CPU tensors: the plain forward, both plain gradients, unrequested ones
    dropped."""

    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.save_for_backward(f1, f2)
        ctx.md = md
        return compute_cost_volume_reference(f1, f2, md)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        need1, need2 = ctx.needs_input_grad[:2]
        gf1, gf2 = cost_volume_grad_reference(g, f1, f2, ctx.md)
        return (gf1 if need1 else None), (gf2 if need2 else None), None


def _step(model, loss_func, img1, img2):
    model.zero_grad()
    res = model(img1, img2, with_bk=True)
    loss = loss_func(res, img1, img2)["total"]
    loss.backward()
    return res, loss, {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}


def test_model_forward_backward_through_the_op_equals_before(monkeypatch):
    """The full-width ``PWCFlow`` and ``UFlowLoss`` at 1x64x96, float32:
    flows, loss and every parameter gradient through the op equal, bit for
    bit, those through the Function the op replaced."""
    cfg = Config({"type": "uflow", "feature_norm": True})
    model = get_model(cfg, device="cpu", seed=3)
    loss_func = get_loss(Config({
        "type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
        "w_census": 1.0, "smooth_order": 1, "with_bk": True}))
    rs = np.random.RandomState(5)
    img1, img2 = (torch.from_numpy(rs.rand(1, 64, 96, 3).astype(np.float32))
                  for _ in range(2))
    before = (COST_VOLUME.launches, COST_VOLUME_BWD.launches)
    res, loss, grads = _step(model, loss_func, img1, img2)
    with monkeypatch.context() as m:
        m.setattr(uflow_module, "compute_cost_volume",
                  lambda a, b, md: _PlainFunction.apply(a, b, md))
        res0, loss0, grads0 = _step(model, loss_func, img1, img2)
    assert (COST_VOLUME.launches, COST_VOLUME_BWD.launches) == before
    assert float(loss.detach()) == float(loss0.detach())
    for key in ("flows_fw", "flows_bw"):
        for a, b in zip(res[key], res0[key]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sorted(grads) == sorted(grads0) and len(grads) > 50
    for name in grads:
        torch.testing.assert_close(grads[name], grads0[name], rtol=0, atol=0,
                                   msg=name)


def test_cuda_implementations_raise_and_never_take_the_plain_path():
    """The ops' CUDA implementations, reached through the dispatcher's CUDA
    key: given tensors that are not on a card (as they would be without
    one), they raise where the kernel wrapper checks its inputs, launch
    nothing and do not fall back to the plain version."""
    keys = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    for op in ("arflow::cost_volume", "arflow::cost_volume_bwd"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
    f1, f2 = _pair((1, 8, 4, 5), 6, dtype=torch.float32)
    g = torch.zeros((1, 81, 4, 5))
    before = (COST_VOLUME.launches, COST_VOLUME_BWD.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        CV.redispatch(keys, f1, f2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        CV_BWD.redispatch(keys, g, f1, f2, 4, True, True)
    assert (COST_VOLUME.launches, COST_VOLUME_BWD.launches) == before


@pytest.mark.gpu
def test_op_on_the_card_launches_both_kernels():
    """On the card the op launches the forward kernel, its backward the
    backward kernel, once each, and a CUDA graph captures the op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(4)
    f1 = torch.randn((2, 32, 24, 40), device="cuda", generator=gen)
    f2 = torch.randn((2, 32, 24, 40), device="cuda", generator=gen)
    before = (COST_VOLUME.launches, COST_VOLUME_BWD.launches)
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = CV(a, b, 4)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert (COST_VOLUME.launches, COST_VOLUME_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.detach(), compute_cost_volume_reference(f1, f2, 4),
                               rtol=0, atol=0)
    graph = torch.cuda.CUDAGraph()
    CV(f1, f2, 4)  # warm-up outside the capture
    with torch.cuda.graph(graph):
        captured = CV(f1, f2, 4)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(captured, out.detach(), rtol=0, atol=0)
