"""The port's spatial training objective (``parallel/spatial.py``:
``spatial_uflow_loss``, ``spatial_value_and_grad``) against the port's own
one-process ``UFlowLoss`` and ``PWCFlow(train=True)``, with no JAX model
(``test_torch_uflow_train_grads.py`` holds it to the JAX
``value_and_grad``): gloo ranks of ``torch_ddp_util.Pool`` on the CPU, a
full-width model from a seed and a 2x64x96 pair, float64 unless a case
says. At 64 rows the 1/32 level has 2 rows, so on the (1, 4) mesh two
ranks own none of it.

- the halo primitive's adjoint: the gradient of every simulated rank's
  rows, through ``halo_edges``' sum and ``halo_take``, equals that of the
  same slices of the zero-padded whole tensor;
- the loss on bands against the whole loss on given flows, ``with_bk``
  both ways, ``smooth_order`` 1 and 2, meshes (1, 2), (1, 4), (2, 2): its
  values, each rank's rows of ``mask1``, and the gradient with respect to
  every flow it reads;
- the objective's loss and parameter gradients against the one-process
  step: the (2, 2) mesh at b2, level dropout 0.5 drawn from one generator
  seed; float32 on (1, 2) and (1, 4) at b1;
- the (1, 1) mesh in this process; what stays refused."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import UFlowLoss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.parallel import (
    make_spatial_mesh,
    row_range,
    shard_images_spatial,
    spatial_forward,
    spatial_uflow_loss,
    spatial_value_and_grad,
)
from arflow_tpu_torch.parallel.spatial import halo_edges, halo_take
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)
from torch_ddp_util import Ranks

B, H, W = 2, 64, 96
MODEL = {"type": "uflow", "feature_norm": True, "level_dropout": 0.5}
SEED = 5  # the level-dropout generator's, on every rank and in one process
LOSSES = [{"type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
           "w_census": 1.0, "smooth_order": order, "with_bk": bk}
          for bk in (True, False) for order in (1, 2)]
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}  # (data, space)
KEYS = ("total", "l_ph", "l_sm", "flow_mean")


@pytest.fixture(scope="module")
def pair():
    rs = np.random.RandomState(0)
    return rs.rand(B, H, W, 3), rs.rand(B, H, W, 3)


@pytest.fixture(scope="module")
def flows():
    """Both directions' 6 NHWC flows at 2x64x96, up to about 10 px at full
    resolution, so that some endpoints leave the image."""
    rs = np.random.RandomState(1)
    return {k: [rs.randn(B, H >> i, W >> i, 2) * 4.0 / (1 << i)
                for i in range(6)] for k in ("flows_fw", "flows_bw")}


@pytest.fixture(scope="module")
def loss_runs(pair, flows, tmp_path_factory):
    """Each mesh's ranks' ``spatial_loss_case`` over every loss config."""
    root = tmp_path_factory.mktemp("spatial_loss")

    def submit(key):
        d, s = MESHES[key]
        case = {"n_spatial": s, "img1": pair[0], "img2": pair[1],
                "flows": flows, "losses": LOSSES}
        return Ranks(case, root / key, world=d * s, entry="spatial_loss_case")

    pending = {key: submit(key) for key in ("1x2", "1x4")}  # two pools at once
    out = {key: r.results() for key, r in pending.items()}
    out["2x2"] = submit("2x2").results()
    return out


@pytest.mark.parametrize("h, n, k", [
    (4, 8, 1), (4, 8, 4), (12, 8, 4), (7, 3, 16), (96, 8, 16), (13, 5, 2),
    (96, 2, 4),
])
def test_halo_take_adjoint_is_the_slices_adjoint(h, n, k):
    """The cases of ``test_halo_rows_equal_slices_of_the_whole``: a random
    cotangent on each simulated rank's rows ``[lo, hi)`` around its band
    back-propagates, through ``halo_take`` and the sum of every rank's
    ``halo_edges``, to each band the gradient that the same slices of the
    zero-padded whole tensor give the whole (the rows a rank lent return
    to their owner as a sum)."""
    gen = torch.Generator().manual_seed(h * 100 + n * 10 + k)
    whole = torch.randn(2, 3, h, 5, generator=gen, dtype=torch.float64,
                        requires_grad=True)
    bands = [whole.detach()[:, :, slice(*row_range(h, n, r))].clone()
             .requires_grad_() for r in range(n)]
    edges = sum(halo_edges(bands[r], h, n, r, k) for r in range(n))
    padded = F.pad(whole, (0, 0, k, k))
    got = want = 0.0
    for r in range(n):
        lo, hi = row_range(h, n, r)
        for a, b in ((lo - k, hi + k), (lo - 1, hi), (lo, hi + k),
                     (lo - k, lo), (hi, hi + k)):
            g = torch.randn(2, 3, b - a, 5, generator=gen, dtype=torch.float64)
            got = got + (halo_take(bands[r], edges, h, n, r, k, a, b) * g).sum()
            want = want + (padded[:, :, a + k:b + k] * g).sum()
    got.backward()
    want.backward()
    band_grads = torch.cat([torch.zeros_like(b) if b.grad is None else b.grad
                            for b in bands], dim=2)  # empty bands: no grad
    torch.testing.assert_close(band_grads, whole.grad, rtol=1e-14, atol=1e-14)


def _whole_of(parts, mesh, h):
    """The global NHWC tensor from each rank's (batch part, rows)."""
    d, s = mesh
    b = parts[0].shape[0]
    whole = np.zeros((b * d, h) + parts[0].shape[2:])
    for rank, part in enumerate(parts):
        i, r = divmod(rank, s)
        whole[i * b:(i + 1) * b, slice(*row_range(h, s, r))] = part
    return whole


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("with_bk", [True, False])
@pytest.mark.parametrize("key", list(MESHES))
def test_band_loss_matches_the_whole_loss(loss_runs, pair, flows, key,
                                          with_bk, order):
    """Every rank's values equal bit for bit, and the whole loss's within
    1e-13 (float64, summation orders apart); ``mask1`` and the gradients
    with respect to the flows (each rank's divided by the mesh's size) put
    together from the ranks' rows equal the whole loss's within 1e-13 of
    their largest entry."""
    i = LOSSES.index({**LOSSES[0], "with_bk": with_bk, "smooth_order": order})
    runs = [r["losses"][i] for r in loss_runs[key]]
    res = {k: [torch.from_numpy(f).requires_grad_() for f in v]
           for k, v in flows.items()}
    img1, img2 = (torch.from_numpy(x) for x in pair)
    want = UFlowLoss(Config(LOSSES[i]))(res, img1, img2)
    want["total"].backward()
    for run in runs:
        assert run["values"] == runs[0]["values"]
    for k in KEYS:
        np.testing.assert_allclose(runs[0]["values"][k], float(want[k].detach()),
                                   rtol=1e-13, err_msg=k)
    mesh = MESHES[key]
    mask1 = _whole_of([r["mask1"] for r in runs], mesh, H)
    np.testing.assert_allclose(mask1, want["mask1"].numpy(), rtol=0,
                               atol=1e-13)
    read = set()
    for k, fs in res.items():
        for level, f in enumerate(fs):
            if f.grad is None:
                assert all(level not in r["grads"][k] for r in runs)
                continue
            read.add((k, level))
            got = _whole_of([r["grads"][k][level] for r in runs], mesh,
                            f.shape[1])
            scale = float(f.grad.abs().max())
            np.testing.assert_allclose(got, f.grad.numpy(), rtol=0,
                                       atol=1e-13 * scale, err_msg=(k, level))
    # without with_bk the backward flows enter only the detached occlusion
    # mask and flow_mean
    assert read == {("flows_fw", 0), ("flows_fw", 2)} | (
        {("flows_bw", 0), ("flows_bw", 2)} if with_bk else set())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("spatial_train") / "w.pt"
    torch.save(get_model(Config(MODEL), device="cpu", seed=0).state_dict(),
               path)
    return path


def _one_process(weights, dtype, img1, img2):
    """The one-process step: the loss's values and each parameter's
    gradient (None where it has none)."""
    model = get_model(Config(MODEL), device="cpu")
    model.load_state_dict(torch.load(weights, weights_only=True))
    model = model.to(dtype)
    a, b = (torch.from_numpy(np.asarray(x)).to(dtype) for x in (img1, img2))
    res = model(a, b, with_bk=True, train=True,
                generator=torch.Generator().manual_seed(SEED))
    out = UFlowLoss(Config(LOSSES[0]))(res, a, b)
    out["total"].backward()
    return ({k: float(out[k].detach()) for k in KEYS},
            {n: None if p.grad is None else p.grad.double().numpy()
             for n, p in model.named_parameters()})


def _rel_l2(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(b * b)) + 1e-12))


OBJECTIVES = {  # (mesh, batch, dtype)
    "2x2-b2-float64": ("2x2", 2, "float64"),
    "1x2-b1-float32": ("1x2", 1, "float32"),
    "1x4-b1-float32": ("1x4", 1, "float32"),
}


@pytest.fixture(scope="module")
def objective_runs(weights, pair, tmp_path_factory):
    """Each objective's ranks' ``spatial_train_case`` (the pools of 2 and 4
    ranks at once), and the one-process steps it is held to, computed
    meanwhile: {name: (ranks' results, {dtype: one-process step})}."""
    root = tmp_path_factory.mktemp("spatial_objective")

    def submit(name):
        key, b, dtype = OBJECTIVES[name]
        d, s = MESHES[key]
        case = {"model": MODEL, "state_dict": str(weights), "dtype": dtype,
                "n_spatial": s, "img1": pair[0][:b], "img2": pair[1][:b],
                "loss": LOSSES[0], "seed": SEED}
        return Ranks(case, root / name, world=d * s, entry="spatial_train_case")

    first = ("2x2-b2-float64", "1x2-b1-float32")
    pending = {name: submit(name) for name in first}
    img1, img2 = (np.float32(x) for x in pair)
    one = {2: {"float64": _one_process(weights, torch.float64, *pair)},
           1: {"float64": _one_process(weights, torch.float64, pair[0][:1],
                                       pair[1][:1]),
               "float32": _one_process(weights, torch.float32, img1[:1],
                                       img2[:1])}}
    runs = {name: r.results() for name, r in pending.items()}
    runs["1x4-b1-float32"] = submit("1x4-b1-float32").results()
    return {name: (runs[name], one[OBJECTIVES[name][1]]) for name in OBJECTIVES}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_spatial_objective_matches_the_one_process_step(objective_runs, name):
    """Every rank's loss and averaged gradients are equal bit for bit.
    float64: the loss within 1e-12 of the one-process step's and each
    parameter's gradient within 1e-10 of its largest entry (the same
    parameters have none). float32: the loss within 1e-5 of the
    one-process float32 step's and the gradients as a whole within 2e-3
    (relative L2, the JAX spatial test's tolerance); each parameter's
    gradient within 5e-3 of the float64 step's, which the one-process
    float32 gradient meets too (both measured up to 3.8e-3 here: the
    one-process float32 gradient moves that far between the CPU's two
    convolution backends)."""
    key, b, dtype = OBJECTIVES[name]
    runs, one = objective_runs[name]
    for run in runs:
        assert run["values"] == runs[0]["values"]
        assert run["digest"] == runs[0]["digest"]
    grads = runs[0]["grads"]
    values64, grads64 = one["float64"]
    assert sorted(grads) == sorted(grads64)
    assert {n for n, g in grads.items() if g is None} == \
        {n for n, g in grads64.items() if g is None}
    names = [n for n, g in grads64.items() if g is not None]
    if dtype == "float64":
        for k in KEYS:
            np.testing.assert_allclose(runs[0]["values"][k], values64[k],
                                       rtol=1e-12, err_msg=k)
        for n in names:
            scale = float(np.abs(grads64[n]).max())
            np.testing.assert_allclose(grads[n], grads64[n], rtol=0,
                                       atol=1e-10 * scale, err_msg=n)
        return
    values32, grads32 = one["float32"]
    np.testing.assert_allclose(runs[0]["values"]["total"], values32["total"],
                               rtol=1e-5)
    flat = np.concatenate([grads[n].ravel() for n in names]).astype(np.float64)
    flat32 = np.concatenate([grads32[n].ravel() for n in names])
    assert _rel_l2(flat, flat32) < 2e-3
    for n in names:
        assert _rel_l2(grads32[n], grads64[n]) < 5e-3, n
        assert _rel_l2(grads[n].astype(np.float64), grads64[n]) < 5e-3, n


def test_one_rank_mesh_equals_the_one_process_step(weights, pair):
    """On the (1, 1) mesh every op runs on one band (the whole image, zero
    halo rows at its edges): the loss equals the one-process step's within
    1e-13 and each gradient within 1e-11 of its largest entry."""
    mesh = make_spatial_mesh(device="cpu")
    model = get_model(Config(MODEL), device="cpu")
    model.load_state_dict(torch.load(weights, weights_only=True))
    model = model.double()
    img1, img2 = shard_images_spatial(mesh, *pair)
    out = spatial_value_and_grad(model, UFlowLoss(Config(LOSSES[0])), mesh,
                                 img1, img2,
                                 generator=torch.Generator().manual_seed(SEED))
    assert out["mask1"].shape == (B, H, W, 1)
    values, grads = _one_process(weights, torch.float64, *pair)
    for k in KEYS:
        np.testing.assert_allclose(float(out[k]), values[k], rtol=1e-13)
    for n, p in model.named_parameters():
        if grads[n] is None:
            assert p.grad is None, n
            continue
        scale = float(np.abs(grads[n]).max())
        np.testing.assert_allclose(p.grad.numpy(), grads[n], rtol=0,
                                   atol=1e-11 * scale, err_msg=n)


@pytest.mark.parametrize("setup", ["bfloat16", "int8", "int8_env",
                                   "uflow_prob", "no_generator"])
def test_spatial_training_refuses_what_is_not_ported(setup, monkeypatch):
    """bfloat16, int8 and other model types raise naming ``ROADMAP.md``'s
    'parallel'; level dropout without a generator raises as
    ``PWCFlow.forward`` does."""
    cfg = dict(MODEL)
    if setup in ("bfloat16", "int8"):
        cfg["dtype"] = setup
    elif setup == "int8_env":
        monkeypatch.setenv("ARFLOW_INT8_PYRAMID", "1")
    elif setup == "uflow_prob":
        cfg = {"type": "uflow_prob", "out_channels": [2, 2, 0]}
    model = get_model(Config(cfg), device="cpu")
    img = torch.rand(1, 64, 64, 3)
    mesh = make_spatial_mesh(device="cpu")
    if setup == "no_generator":
        with pytest.raises(ValueError, match="torch.Generator"):
            spatial_forward(model, mesh, img, img, train=True)
        return
    with pytest.raises(NotImplementedError, match="'parallel'"):
        spatial_value_and_grad(model, UFlowLoss(Config(LOSSES[0])), mesh,
                               img, img,
                               generator=torch.Generator().manual_seed(0))
