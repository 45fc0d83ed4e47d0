"""The port's spatial (image-height) sharding of the UFlow forward against
the JAX single-device ``PWCFlow`` forward, as ``tests/test_spatial_sharding.py``
holds the JAX package's GSPMD version: the same weights (numpy, through
``uflow_state_dict_from_jax``) and a 2x128x96 pair from a seed, both
directions, on gloo ranks on the CPU (``torch_ddp_util.spatial_case``):
meshes (1, 2) and (2, 2) at batch 2 and (1, 4) at batch 1, in float64
against the JAX side in float64 with its relayouts off, and in float32 at
the JAX test's own tolerance. At 128 rows the 1/32 level has 4 rows, so
the (1, 4) ranks own one row each there. The halo primitive alone against
slices of a whole tensor, with the ranks simulated in one process (empty
bands and bands thinner than the halo among them); the (1, 1) mesh in this
process against the one-process forward; the refusals."""

import os
from unittest import mock

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model, uflow_state_dict_from_jax
from arflow_tpu_torch.parallel import (
    gather_flows,
    make_spatial_mesh,
    row_range,
    shard_images_spatial,
    spatial_forward,
    spatial_image_sharding,
)
from arflow_tpu_torch.parallel.spatial import halo_edges, halo_take
from torch_ddp_util import Ranks
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    few_torch_threads,
    jax_forward,
    jax_params,
)

GATES_OFF = {"ARFLOW_WFOLD_PYR": "0", "ARFLOW_PYR_BATCH": "0", "ARFLOW_HFOLD": "0"}
MESHES = {"1x2": (1, 2, 2), "2x2": (2, 2, 2), "1x4": (1, 4, 1)}  # data, space, batch
KEYS = ("flows_bw", "flows_fw")


@pytest.fixture(scope="module")
def images():
    """As ``tests/test_spatial_sharding.py`` makes them."""
    rng = np.random.RandomState(0)
    b, h, w = 2, 128, 96
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


@pytest.fixture(scope="module")
def runs(jax_params, images, tmp_path_factory):
    """Each mesh's rank results, and the JAX forwards (float64 with the
    relayouts off, float32 with them off too) computed while the first
    ranks run."""
    root = tmp_path_factory.mktemp("spatial")
    sd = str(root / "w.pt")
    torch.save(uflow_state_dict_from_jax(jax_params), sd)
    img1, img2 = images

    def submit(key):
        d, s, b = MESHES[key]
        case = {"model": CFG, "state_dict": sd, "n_spatial": s,
                "dtypes": ("float64", "float32"),
                "img1": img1[:b], "img2": img2[:b]}
        return Ranks(case, root / key, world=d * s, entry="spatial_case")

    pending = {key: submit(key) for key in ("1x2", "2x2")}
    ref = {}
    with mock.patch.dict(os.environ, GATES_OFF):
        for name, dt in (("float64", jnp.float64), ("float32", jnp.float32)):
            res = jax_forward(jax_params, img1, img2, True, dt)
            ref[name] = {k: [np.asarray(f) for f in res[k]] for k in KEYS}
    out = {key: r.results() for key, r in pending.items()}
    out["1x4"] = submit("1x4").results()
    return out, ref


def _check_ranks(results, key):
    d, s, b = MESHES[key]
    assert len(results) == d * s
    for rank, res in enumerate(results):
        assert res["shape"] == (d, s) and res["axes"] == ("data", "space")
        assert res["coords"] == divmod(rank, s)
        assert "do not factor" in res["refusal"]
        r = rank % s
        for name in ("float64", "float32"):
            for k in KEYS:
                for level, shape in enumerate(res[name]["rows"][k]):
                    h = 128 >> level
                    lo, hi = row_range(h, s, r)
                    assert shape == (b // d, hi - lo, 96 >> level, 2), (level, shape)


@pytest.mark.parametrize("key", list(MESHES))
def test_spatial_forward_matches_jax_single_device(runs, key):
    results, ref = runs[0][key], runs[1]
    _check_ranks(results, key)
    b = MESHES[key][2]
    gaps = {}
    for name in ("float64", "float32"):
        flows = results[0][name]["flows"]
        for other in results[1:]:  # every rank gathers the same flows
            for k in KEYS:
                for f, g in zip(flows[k], other[name]["flows"][k]):
                    np.testing.assert_array_equal(f, g)
        for k in KEYS:
            assert len(flows[k]) == 6
            for f, want in zip(flows[k], ref[name][k]):
                want = want[:b]
                assert f.shape == want.shape and f.dtype == want.dtype
                assert np.isfinite(f).all()
                gaps[name] = max(gaps.get(name, 0.0),
                                 float(np.abs(f - want).max()))
                if name == "float32":
                    # the JAX test's tolerance for its GSPMD forward
                    np.testing.assert_allclose(f, want, atol=2e-5, rtol=1e-5)
    # float64 on both sides, summation orders apart (measured: at most
    # 2.5e-14 px on flows of up to 19 px).
    assert gaps["float64"] < 1e-10, gaps


@pytest.mark.parametrize("h, n, k", [
    (4, 8, 1),    # four bands of one row, four empty
    (4, 8, 4),    # a halo wider than the whole level
    (12, 8, 4),   # the 1/32 level of 384 rows: bands of 1 and 2 rows
    (7, 3, 16),
    (96, 8, 16),  # the refinement's dilation 16 at the 1/4 level
    (13, 5, 2),
    (96, 2, 4),   # a middle row that no halo of 4 reaches
])
def test_halo_rows_equal_slices_of_the_whole(h, n, k):
    """Each simulated rank's rows ``[lo, hi)`` around its band, from its
    band and the sum of every rank's ``halo_edges``, equal the zero-padded
    whole tensor's; a row beyond ``k`` of its owner's edge raises."""
    gen = torch.Generator().manual_seed(h * 100 + n * 10 + k)
    whole = torch.randn(2, 3, h, 5, generator=gen, dtype=torch.float64)
    bands = [whole[:, :, slice(*row_range(h, n, r))] for r in range(n)]
    edges = sum(halo_edges(bands[r], h, n, r, k) for r in range(n))
    padded = F.pad(whole, (0, 0, k, k))
    for r in range(n):
        lo, hi = row_range(h, n, r)
        for a, b in ((lo - k, hi + k), (lo - 1, hi), (lo, hi + k),
                     (lo - k, lo), (hi, hi + k), (lo, hi)):
            got = halo_take(bands[r], edges, h, n, r, k, a, b)
            assert torch.equal(got, padded[:, :, a + k:b + k]), (r, a, b)
    if h // n > 2 * k + 1:  # a band with a middle row no halo reaches
        lo, hi = row_range(h, n, 1)
        with pytest.raises(ValueError, match="not within"):
            halo_take(bands[0], edges, h, n, 0, k, row_range(h, n, 0)[0],
                      lo + k + 1)


def test_one_rank_mesh_equals_the_one_process_forward(jax_params):
    """The (1, 1) mesh runs every op on bands (the whole image, zero halo
    rows at its edges) and reads the one-process forward."""
    mesh = make_spatial_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "space")
    assert spatial_image_sharding(mesh, 2, 64) == [(slice(0, 2), slice(0, 64))]
    with pytest.raises(ValueError, match="do not factor"):
        make_spatial_mesh(n_spatial=2, device="cpu")
    model = get_model(Config(CFG), device="cpu")
    model.load_state_dict(uflow_state_dict_from_jax(jax_params), strict=True)
    model = model.double()
    rs = np.random.RandomState(3)
    img1, img2 = rs.rand(2, 2, 64, 96, 3)
    res = spatial_forward(model, mesh, *shard_images_spatial(mesh, img1, img2))
    whole = gather_flows(mesh, res)
    with torch.no_grad():
        ref = model(torch.from_numpy(img1), torch.from_numpy(img2))
    for k in KEYS:
        for f, g, want in zip(res[k], whole[k], ref[k]):
            assert torch.equal(f, g)
            assert float((f - want).abs().max()) < 1e-12


@pytest.mark.parametrize("setup", ["train_bfloat16", "bfloat16", "int8",
                                   "int8_env", "uflow_prob"])
def test_spatial_forward_refuses_what_is_not_ported(setup, monkeypatch):
    cfg, train = dict(CFG), setup == "train_bfloat16"
    if setup in ("bfloat16", "int8"):
        cfg["dtype"] = setup
    elif setup == "train_bfloat16":
        cfg["dtype"] = "bfloat16"
    elif setup == "int8_env":
        monkeypatch.setenv("ARFLOW_INT8_PYRAMID", "1")
    elif setup == "uflow_prob":
        cfg = {"type": "uflow_prob", "out_channels": [2, 2, 0]}
    model = get_model(Config(cfg), device="cpu")
    img = torch.rand(1, 64, 64, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        spatial_forward(model, make_spatial_mesh(device="cpu"), img, img,
                        train=train)
