"""The port's native library (``arflow_tpu_torch/native``) against the JAX
package's (``arflow_tpu.native``), bit for bit: PNG (8-bit RGB and RGBA,
grey, 16-bit grey, palette), PPM and PGM decode, ``.flo`` and KITTI PNG
flow, the bilinear resize and their callers. The hue shift is held to the
numpy hue of both packages bit for bit, and to the JAX library's within
its measured gap from numpy. Two processes building into one empty
directory at once end with one working library.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from arflow_tpu import native as jax_native
from arflow_tpu.data import transforms as jax_tf
from arflow_tpu.utils import flow_io as jax_flow_io
from arflow_tpu_torch import native
from arflow_tpu_torch.data import datasets
from arflow_tpu_torch.data import transforms as tf
from arflow_tpu_torch.utils import flow_io
from torch_data_util import few_torch_threads, write_ppm  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason=f"g++ or libpng missing: {native.build_error()}")


def assert_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _png(path, kind, rs):
    from PIL import Image

    if kind == "rgb8":
        im = Image.fromarray((rs.rand(20, 30, 3) * 255).astype(np.uint8))
    elif kind == "rgba8":
        im = Image.fromarray((rs.rand(20, 30, 4) * 255).astype(np.uint8), "RGBA")
    elif kind == "grey8":
        im = Image.fromarray((rs.rand(12, 14) * 255).astype(np.uint8), "L")
    elif kind == "grey16":
        im = Image.fromarray((rs.rand(12, 14) * 65535).astype(np.uint16))
    else:  # palette
        im = Image.fromarray((rs.rand(12, 14, 3) * 255).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=16)
    im.save(path)
    return im


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey8", "grey16", "palette"])
def test_png_decode_matches_jax(tmp_path, kind):
    pytest.importorskip("PIL")
    from PIL import Image

    p = str(tmp_path / f"{kind}.png")
    _png(p, kind, np.random.RandomState(0))
    assert native.image_shape(p) == jax_native.image_shape(p)
    for channels in (3, 1):
        assert_bits(native.load_image(p, channels=channels),
                    jax_native.load_image(p, channels=channels))
    if kind != "grey16":  # PIL's "RGB" of a 16-bit grey clips, libpng scales
        with Image.open(p) as im:
            pil = np.asarray(im.convert("RGB"), np.float32) / 255.0
        # px * (1/255) against px / 255: within an ulp
        np.testing.assert_allclose(native.load_image(p), pil, rtol=0, atol=6e-8)


def test_ppm_and_pgm_decode_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    rgb = (rs.rand(16, 22, 3) * 255).astype(np.uint8)
    write_ppm(tmp_path / "a.ppm", rgb)
    gray = (rs.rand(9, 5) * 255).astype(np.uint8)
    with open(tmp_path / "b.pgm", "wb") as f:
        f.write(b"P5\n# comment\n5 9\n255\n" + gray.tobytes())
    for name in ("a.ppm", "b.pgm"):
        p = str(tmp_path / name)
        assert native.image_shape(p) == jax_native.image_shape(p)
        for channels in (3, 1):
            assert_bits(native.load_image(p, channels=channels),
                        jax_native.load_image(p, channels=channels))
    np.testing.assert_allclose(native.load_image(str(tmp_path / "a.ppm")),
                               rgb.astype(np.float32) / 255.0, rtol=0, atol=6e-8)


def test_decode_into_stacked_slices(tmp_path):
    rs = np.random.RandomState(2)
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"{i}.ppm")
        write_ppm(paths[-1], (rs.rand(10, 12, 3) * 255).astype(np.uint8))
    out = np.full((3, 10, 12, 3), -1.0, np.float32)
    for i, p in enumerate(paths):
        got = native.load_image(str(p), out=out[i])
        assert np.shares_memory(got, out[i])
    assert_bits(out, np.stack([jax_native.load_image(str(p)) for p in paths]))
    assert_bits(datasets.load_image_stack(paths), out)
    assert_bits(datasets.load_image(paths[0]), out[0])
    with pytest.raises(ValueError, match="unsupported"):
        native.image_shape(str(tmp_path / "x.jpg"))
    assert native.supports("a.PNG") and not native.supports("a.jpg")


def test_flo_matches_jax(tmp_path):
    flow = np.random.RandomState(3).randn(10, 12, 2).astype(np.float32)
    p = str(tmp_path / "f.flo")
    flow_io.write_flo(p, flow)
    assert_bits(native.read_flo(p), jax_native.read_flo(p))
    assert_bits(native.read_flo(p), flow)
    assert_bits(flow_io.load_flow(p), flow)


def test_kitti_png_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    rs = np.random.RandomState(4)
    flow = (rs.randn(12, 16, 2) * 10).astype(np.float32)
    mask = (rs.rand(12, 16) > 0.3).astype(np.uint16)
    p = str(tmp_path / "k.png")
    jax_flow_io.write_kitti_png(p, flow, mask)
    ours = native.read_kitti_png(p)
    assert_bits(ours, jax_native.read_kitti_png(p))
    assert_bits(flow_io.load_flow(p), ours)
    np.testing.assert_allclose(ours, flow_io.read_kitti_png(p), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,out", [((17, 23, 3), (9, 31)),
                                       ((32, 48, 3), (64, 96)),
                                       ((40, 30, 2), (40, 17))])
def test_resize_matches_jax(shape, out):
    img = np.random.RandomState(5).rand(*shape).astype(np.float32)
    assert_bits(native.resize_bilinear(img, out),
                jax_native.resize_bilinear(img, out))


def test_scale_matches_jax_native():
    frames = np.random.RandomState(6).rand(2, 24, 40, 3).astype(np.float32)
    assert_bits(tf.Scale((37, 50))(frames), jax_tf.Scale((37, 50))(frames))
    assert_bits(tf.Scale((37, 50))(frames[0]), jax_tf.Scale((37, 50))(frames[0]))
    # float32 weights: within 5e-5 of the float64 resize matrix
    np.testing.assert_allclose(tf.Scale((37, 50))(frames),
                               tf.resize_bilinear_np(frames, (37, 50)),
                               rtol=0, atol=5e-5)


def _hue_frames(seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(2, 40, 56, 3).astype(np.float32)
    x[1] = (rs.randint(0, 256, x[1].shape) / 255.0).astype(np.float32)
    x[0, :4] = x[0, :4, :, :1]  # grey
    x[0, 4:8, :, 1] = x[0, 4:8, :, 0]  # ties
    x[1, :3, :, 2] = x[1, :3, :, 0]
    # hue 0 (with a shift of -1e-9 it rounds up to 1.0: sector 6), a hue
    # that rounds up to 1.0 before the shift, black, white, a tie
    x[1, 3, :5] = [[1.0, 0.0, 0.0], [1.0, 0.0, 1e-7], [0.0, 0.0, 0.0],
                   [1.0, 1.0, 1.0], [0.5, 0.5, 0.25]]
    return x


def _numpy_hue(module, x, d):
    hsv = module._rgb_to_hsv(x)
    hsv[..., 0] = (hsv[..., 0] + d) % 1.0
    return module._hsv_to_rgb(hsv)


@pytest.mark.parametrize("d", [0.0, 1e-9, -1e-9, -0.37, 0.1, 0.4999])
def test_hue_matches_numpy_bit_for_bit(d):
    """The port's native hue against its numpy hue and the JAX package's
    numpy hue, bit for bit. Against the JAX library, which rounds otherwise,
    within 2e-6 (1.3e-6 measured at most) away from sector 6, which it
    reads as sector 5 (d = -1e-9 on a hue-0 pixel: blue 1 for 0)."""
    x = _hue_frames(7)
    got = native.hue_shift(x, d)
    assert_bits(got, _numpy_hue(tf, x, d))
    assert_bits(got, _numpy_hue(jax_tf, x, d))
    jax_got = jax_native.hue_shift(x, d)
    sector6 = (tf._rgb_to_hsv(x)[..., 0] + d) % 1.0 == 1.0
    if d == -1e-9:
        assert sector6[1, 3, 0]
        assert got[1, 3, 0].tolist() == [1.0, 0.0, 0.0]
        assert jax_got[1, 3, 0].tolist() == [1.0, 0.0, 1.0]
    np.testing.assert_allclose(got[~sector6], jax_got[~sector6], rtol=0,
                               atol=2e-6)


def test_color_jitter_hue_native_equals_numpy(monkeypatch):
    x = _hue_frames(8)
    on = tf.ColorJitter(hue=0.5, rng=np.random.RandomState(9))
    outs_on = [on(x) for _ in range(4)]
    monkeypatch.setattr(native, "available", lambda: False)
    off = tf.ColorJitter(hue=0.5, rng=np.random.RandomState(9))
    for a in outs_on:
        assert_bits(a, off(x))


_BUILD = r"""
import hashlib, sys
from pathlib import Path
import numpy as np
from arflow_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available(), native.build_error()
x = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
print(native.library_path(native.VARIANTS[0]).name,
      hashlib.sha256(native.hue_shift(x, 0.3).tobytes()).hexdigest())
"""


def test_two_processes_build_into_one_empty_dir(tmp_path):
    build = tmp_path / "_build"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1  # the same library and the same hue
    name, digest = lines.pop().split()
    x = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    assert digest == hashlib.sha256(native.hue_shift(x, 0.3).tobytes()).hexdigest()
    assert sorted(p.name for p in build.iterdir()) == ["arflow_io.lock", name]


_NO_PNG = r"""
import sys
from pathlib import Path
import numpy as np
from PIL import Image
from arflow_tpu_torch import native
from arflow_tpu_torch.data import datasets
native.BUILD_DIR = Path(sys.argv[1])
native.VARIANTS = native.VARIANTS[1:]  # as on a host without png.h
assert native.available() and not native.has_png()
assert native.supports("a.ppm") and not native.supports("a.png")
x = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
png = str(Path(sys.argv[1]) / "a.png")
Image.fromarray((x * 255).astype(np.uint8)).save(png)
with Image.open(png) as im:
    pil = np.asarray(im.convert("RGB"), np.float32) / 255.0
assert np.array_equal(datasets.load_image(png), pil)  # PIL's path
assert np.array_equal(datasets.load_image_stack([png, png])[1], pil)
print(native.hue_shift(x, 0.3).tobytes().hex())
"""


def test_build_without_libpng(tmp_path):
    """A host without libpng's headers gets the library without PNG
    support: PPM, flow, resize and the hue as ever, PNG through PIL."""
    pytest.importorskip("PIL")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _NO_PNG, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    x = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    assert out.stdout.strip() == native.hue_shift(x, 0.3).tobytes().hex()

