"""``arflow_tpu_torch/tools/real_frame_train.py`` against the JAX package's
tool, on the CPU at 2 steps and 64x96 on the tests' generated frames
(``tests/fixtures``, as ``test_real_frame_tool.py``), with no JAX model
compile: both modes write the JAX tool's artifacts and report keys with
finite values; the model and loss configs are the JAX tool's (read from
it, its ``get_model`` / ``get_loss`` replaced by recorders); the frames
the port loads equal the JAX tool's loader's, so the identity warp's PSNR
is the JAX formula's on them; a missing ``--frames`` raises naming the
flag. The step's numerics are held by ``test_torch_uflow_train_grads.py``
(``uflow`` + ``UFlowLoss``) and ``test_torch_elbo_loss.py`` (the diag
ELBO); the 300-step runs are ``chip_smoke.py``'s ``tools`` phase."""

import json
import os

import numpy as np
import pytest

import arflow_tpu.losses as jax_losses
import arflow_tpu.models as jax_models
from arflow_tpu.tools import real_frame_train as jax_real_frame_train
from arflow_tpu_torch.tools import real_frame_train
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

# arflow_tpu/tools/real_frame_train.py:188-203
JAX_KEYS = {"metric", "frames", "size", "steps", "loss_first", "loss_last",
            "census_lph_init", "census_lph_final", "warp_psnr_identity",
            "warp_psnr_init", "warp_psnr_trained", "mean_abs_flow_px", "elbo",
            "out"}
SIZE = (64, 96)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The fixtures' frames, generated into this module's own directory."""
    from tests.fixtures import ensure_photo_frames

    return ensure_photo_frames(str(tmp_path_factory.mktemp("frames")))


class Recipe(Exception):
    """Raised by the recorded ``get_loss``: the JAX tool's configs are
    read, nothing is traced."""


@pytest.mark.parametrize("elbo", [False, True], ids=["uflow", "elbo"])
def test_real_frame_tool_two_steps(frames, tmp_path, capsys, elbo):
    out = tmp_path / ("elbo" if elbo else "uflow")
    argv = ["--steps", "2", "--size", "64x96", "--out", str(out),
            "--frames", frames, "--device", "cpu"] + (["--elbo"] if elbo else [])
    report = real_frame_train.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert set(report) == JAX_KEYS
    assert report["metric"] == "real_frame_unsupervised_train"
    assert report["steps"] == 2 and report["size"] == "64x96"
    assert report["elbo"] is elbo and report["out"] == str(out)
    for key in JAX_KEYS - {"metric", "frames", "size", "steps", "elbo", "out"}:
        assert np.isfinite(report[key]), key
    names = {"img1_img2.flo", "img1_img2_flow.png"}
    if elbo:
        names |= {"img1_img2_entropy.npy", "img1_img2_entropy.png"}
    assert set(os.listdir(out)) == names
    from arflow_tpu_torch.utils.flow_io import read_flo

    flow = read_flo(str(out / "img1_img2.flo"))
    assert flow.shape == (*SIZE, 2) and np.isfinite(flow).all()
    assert report["mean_abs_flow_px"] == round(float(np.abs(flow).mean()), 2)
    if elbo:
        ent = np.load(out / "img1_img2_entropy.npy")
        assert ent.shape == SIZE and np.isfinite(ent).all()


def test_frames_and_identity_psnr_equal_jax(frames, tmp_path):
    """The port's ``load_image`` + ``Scale`` against the JAX tool's loader
    (``arflow_tpu.data.datasets.load_image`` + ``Scale``, each package
    with its native library where built), within 1e-6; the report's
    ``warp_psnr_identity`` is the JAX formula on the JAX frames."""
    from arflow_tpu.data.datasets import load_image
    from arflow_tpu.data.transforms import Scale

    got = real_frame_train.load_frames(frames, *SIZE)
    want = [Scale(SIZE)(load_image(os.path.join(frames, n)))[None]
            for n in ("img1.png", "img2.png")]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, *SIZE, 3) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    mse_id = float(np.mean(np.square(want[1] - want[0])))
    report = real_frame_train.main(["--steps", "1", "--size", "64x96", "--out",
                                    str(tmp_path), "--frames", frames,
                                    "--device", "cpu"])
    assert report["warp_psnr_identity"] == round(10 * np.log10(1.0 / mse_id), 2)


@pytest.mark.parametrize("elbo,dtype", [(False, None), (True, None), (False, "bf16")])
def test_configs_are_jax(frames, monkeypatch, elbo, dtype):
    """The JAX tool's model and loss sections, and the port's."""
    seen = {}
    monkeypatch.setenv("ARFLOW_USE_PALLAS", "1")  # the tool's setdefault

    def model(cfg):
        seen["model"] = dict(cfg)

    def loss(cfg):
        seen["loss"] = dict(cfg)
        raise Recipe

    monkeypatch.setattr(jax_models, "get_model", model)
    monkeypatch.setattr(jax_losses, "get_loss", loss)
    argv = ["--frames", frames, "--size", "64x96"]
    argv += (["--elbo"] if elbo else []) + (["--dtype", dtype] if dtype else [])
    with pytest.raises(Recipe):
        jax_real_frame_train.main(argv)
    model_cfg = real_frame_train.ELBO_MODEL if elbo else real_frame_train.UFLOW_MODEL
    want_model = dict(model_cfg, **({"dtype": dtype} if dtype else {}))
    assert seen["model"] == want_model
    assert seen["loss"] == (real_frame_train.ELBO_LOSS if elbo
                            else real_frame_train.UFLOW_LOSS)
    args = real_frame_train.parse_args([])
    defaults = {"steps": 300, "size": "384x640", "lr": 2e-4, "dtype": None,
                    "elbo": False, "device": "cuda"}
    assert {k: getattr(args, k) for k in defaults} == defaults


@pytest.mark.parametrize("frames_arg", [None, "missing"])
def test_missing_frames_raise_naming_the_flag(tmp_path, frames_arg):
    argv = ["--steps", "1", "--size", "64x96", "--device", "cpu",
            "--out", str(tmp_path / "out")]
    if frames_arg:
        argv += ["--frames", str(tmp_path / frames_arg)]
    with pytest.raises(FileNotFoundError, match="--frames"):
        real_frame_train.main(argv)
    assert not (tmp_path / "out").exists()
