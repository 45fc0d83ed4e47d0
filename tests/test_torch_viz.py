"""The port's flow images and image summaries against the JAX package's,
bit for bit: ``utils/viz.py``, ``SummaryWriter.add_image`` /
``add_images`` (the PNG pixels, the file names and the ``events.jsonl``
rows), and the ELBO trainer's ``_draw_weights``. TensorBoard is kept from
importing (it would import TensorFlow); its writer is not compared.
"""

import json
import os
import sys

import numpy as np
import pytest

from arflow_tpu.training.uflow_elbo_trainer import _draw_weights as jax_draw_weights
from arflow_tpu.utils import summary as jax_summary
from arflow_tpu.utils import viz as jax_viz
from arflow_tpu_torch.training.uflow_elbo_trainer import _draw_weights
from arflow_tpu_torch.utils import summary, viz
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, mod, None)


def _flow(seed, shape=(2, 24, 32, 2)):
    return (np.random.RandomState(seed).randn(*shape) * 5).astype(np.float32)


def assert_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_flow", [256, 3.0, None])
def test_flow_to_image_matches_jax(max_flow):
    flow = _flow(0)[0]
    assert_bits(viz.flow_to_image(flow, max_flow),
                jax_viz.flow_to_image(flow, max_flow))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hsv_to_rgb_matches_jax(dtype):
    hsv = np.random.RandomState(1).rand(16, 20, 3).astype(dtype)
    hsv[0, :3, 0] = [0.0, 1.0, 5.0 / 6.0]
    assert_bits(viz._hsv_to_rgb(hsv), jax_viz._hsv_to_rgb(hsv))


def test_flow2rgb_matches_jax():
    flows = _flow(2)
    for f in (flows[0], np.transpose(flows[0], (2, 0, 1))):
        assert_bits(viz.np_flow2rgb(f), jax_viz.np_flow2rgb(f))
        assert_bits(viz.np_flow2rgb(f, 4.0), jax_viz.np_flow2rgb(f, 4.0))
    assert_bits(viz.batch_flow2rgb(flows), jax_viz.batch_flow2rgb(flows))
    zero = np.zeros((1, 8, 8, 2), np.float32)
    assert_bits(viz.batch_flow2rgb(zero), jax_viz.batch_flow2rgb(zero))


def _rows(log_dir):
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert set(r) >= {"t", "tag", "step"}
        r.pop("t")
        if "image" in r:
            r["image"] = os.path.relpath(r["image"], log_dir)
    return rows


def test_add_image_matches_jax_writer(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rs = np.random.RandomState(3)
    images = {
        "Valid/pred_0": viz.batch_flow2rgb(_flow(4)),  # float [0, 1], B=2
        "Valid/mask_0": rs.rand(2, 24, 32, 1).astype(np.float32),  # one channel
        "Valid/over": rs.randn(1, 12, 16, 3) * 2,  # clipped, float64
    }
    single = (rs.rand(10, 14, 3) * 255).astype(np.uint8)
    for module, d in ((summary, "port"), (jax_summary, "jax")):
        w = module.SummaryWriter(str(tmp_path / d))
        w.add_scalar("Valid_EPE_0", 1.5, 3)
        for tag, imgs in images.items():
            w.add_images(tag, imgs, 3)
        w.add_image("Valid/splot_0", single, 4)
        w.close()
    port_rows, jax_rows = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert port_rows == jax_rows
    assert [r["tag"] for r in port_rows] == [
        "Valid_EPE_0", "Valid/pred_0/0", "Valid/pred_0/1", "Valid/mask_0/0",
        "Valid/mask_0/1", "Valid/over/0", "Valid/splot_0"]
    assert port_rows[1]["image"] == os.path.join("images", "Valid_pred_0_0_3.png")
    names = sorted(os.listdir(tmp_path / "port" / "images"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "images"))
    assert len(names) == 6
    for name in names:
        with Image.open(tmp_path / "port" / "images" / name) as a, \
                Image.open(tmp_path / "jax" / "images" / name) as b:
            assert a.mode == b.mode
            assert_bits(np.asarray(a), np.asarray(b))
    with Image.open(tmp_path / "port" / "images" / "Valid_splot_0_4.png") as im:
        assert_bits(np.asarray(im), single)


def test_draw_weights_matches_jax():
    pytest.importorskip("PIL")
    images = viz.batch_flow2rgb(_flow(5, (3, 32, 40, 2)))
    weights = np.float32([0.25, 0.5, 0.125])
    got = _draw_weights(images, weights)
    assert_bits(got, jax_draw_weights(images, weights))
    assert not np.array_equal(got, images)  # the text is drawn
