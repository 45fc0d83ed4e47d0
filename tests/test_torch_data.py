"""The port's data pipeline against ``arflow_tpu``'s, bit for bit: ``.flo``
IO, the resize matrix, every transform from the same ``RandomState``
seeds, the numpy PPM reader against PIL, each dataset's sample collection,
and ``build_loaders`` over two epochs of ``configs/chairs_uflow.json``'s
data section.

Both packages are pinned to their PIL/numpy paths: the native decoders
and resize compute in another order and may differ from them in the last
bit. One case runs ``build_loaders`` with both native libraries on.
"""

import json
import os
import sys

import numpy as np
import pytest

import arflow_tpu.native
import arflow_tpu_torch.native
from arflow_tpu.cli import build_loaders as jax_build_loaders
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.data import datasets as jax_datasets
from arflow_tpu.data import transforms as jax_tf
from arflow_tpu.ops.resize import _resize_matrix as jax_resize_matrix
from arflow_tpu.utils import flow_io as jax_flow_io
from arflow_tpu_torch import Config
from arflow_tpu_torch.cli import build_loaders
from arflow_tpu_torch.data import datasets
from arflow_tpu_torch.data import transforms as tf
from arflow_tpu_torch.data.loader import DataLoader, InMemoryDataset
from arflow_tpu_torch.ops.resize import _resize_matrix
from arflow_tpu_torch.utils import flow_io
from torch_data_util import (  # noqa: F401  (few_torch_threads: fixture)
    few_torch_threads,
    make_chairs_dir,
    write_ppm,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


JAX_NATIVE = arflow_tpu.native.available
PORT_NATIVE = arflow_tpu_torch.native.available


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    monkeypatch.setattr(arflow_tpu.native, "available", lambda: False)
    monkeypatch.setattr(arflow_tpu_torch.native, "available", lambda: False)


def assert_same(a, b, where="batch"):
    """Equal trees of dicts, lists, strings and arrays, bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], str):
        assert list(a) == list(b), where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_flo_io_matches_jax(tmp_path):
    flow = np.random.RandomState(0).randn(7, 11, 2).astype(np.float32)
    flow_io.write_flo(str(tmp_path / "port.flo"), flow)
    jax_flow_io.write_flo(str(tmp_path / "jax.flo"), flow)
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    for path in ("port.flo", "jax.flo"):
        got = flow_io.read_flo(str(tmp_path / path))
        assert_same(got, jax_flow_io.read_flo(str(tmp_path / path)))
        assert_same(got, flow)
    assert_same(flow_io.load_flow(tmp_path / "port.flo"), flow)


@pytest.mark.parametrize("n,out", [(64, 32), (37, 96), (384, 512), (13, 5),
                                   (1, 4), (8, 1)])
def test_resize_matrix_matches_jax(n, out):
    assert_same(_resize_matrix(n, out), jax_resize_matrix(n, out, "bilinear", False))


TRANSFORMS = {
    "crop": lambda m, rs: m.RandomCrop((20, 30), rng=rs),
    "hflip": lambda m, rs: m.RandomHorizontalFlip(rng=rs),
    "scale_down": lambda m, rs: m.Scale((17, 29)),
    "scale_up": lambda m, rs: m.Scale((70, 100)),
    "color_jitter": lambda m, rs: m.ColorJitter(0.3, 0.3, 0.3, 0.5, rng=rs),
    "hue": lambda m, rs: m.ColorJitter(hue=0.5, rng=rs),
    "gamma": lambda m, rs: m.RandomGamma(rng=rs),
    "swap_channels": lambda m, rs: m.RandomSwapChannels(rng=rs),
    "geometric_factory": lambda m, rs: m.get_geometric_transforms(
        m_cfg(m, {"crop": True, "crop_size": [24, 40], "hflip": True,
                  "scale": True, "scale_size": [16, 24]}), rs),
    "photometric_factory": lambda m, rs: m.get_photometric_transforms(
        m_cfg(m, {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2,
                  "hue": 0.5, "gamma": 1, "swap_channels": True}), rs),
}


def m_cfg(module, d):
    return Config(d) if module is tf else JaxConfig(d)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    frames = np.random.RandomState(1).rand(2, 32, 48, 3).astype(np.float32)
    port = TRANSFORMS[name](tf, np.random.RandomState(7))
    jax_t = TRANSFORMS[name](jax_tf, np.random.RandomState(7))
    for _ in range(6):  # successive draws from the shared RandomState
        assert_same(port(frames), jax_t(frames), name)


def _pil_decode(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def test_ppm_reader_matches_pil(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rs = np.random.RandomState(2)
    rgb = (rs.rand(13, 21, 3) * 255).astype(np.uint8)
    rgb[0, 0] = (0, 255, 128)
    gray = (rs.rand(9, 5) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "pil.ppm")
    Image.fromarray(gray).save(tmp_path / "pil.pgm")
    write_ppm(tmp_path / "numpy.ppm", rgb)
    # a comment and other whitespace in the header
    (tmp_path / "comment.ppm").write_bytes(
        b"P6 # written by hand\n21\t13\r\n# maxval next\n255\n" + rgb.tobytes())
    for name in ("pil.ppm", "pil.pgm", "numpy.ppm", "comment.ppm"):
        got = datasets.load_image(tmp_path / name)
        assert_same(got, _pil_decode(tmp_path / name), name)
    assert_same(datasets.load_image(tmp_path / "numpy.ppm"),
                rgb.astype(np.float32) / 255.0)
    (tmp_path / "ascii.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="magic"):
        datasets.load_image(tmp_path / "ascii.ppm")


def test_png_without_pil_names_the_file_type(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.png"):
        datasets.load_image(tmp_path / "frame_0001.png")


def _touch(root, rel):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")


def _tree(root, kind):
    """Empty files in each dataset's layout: collection looks only at
    names."""
    if kind == "sintel":
        for scene in ("alley_1", "market_6"):
            for fid in (1, 2, 3):
                _touch(root, f"training/final/{scene}/frame_{fid:04d}.png")
                _touch(root, f"training/flow/{scene}/frame_{fid:04d}.flo")
    elif kind == "sintel_raw":
        for scene in ("a", "b"):
            for fid in range(4):
                _touch(root, f"{scene}/frame_{fid:04d}.png")
    elif kind == "chairs":
        for fid in (5, 6, 7, 18):
            for i in (1, 2):
                _touch(root, f"{fid:05d}_img{i}.ppm")
            _touch(root, f"{fid:05d}_flow.flo")
    elif kind == "chairs2":
        for fid in (0, 1):
            for name in ("img_0.png", "img_1.png", "flow_01.flo", "flow_10.flo"):
                _touch(root, f"train/{fid:07d}-{name}")
    elif kind == "kitti":
        for seq in ("000000", "000001"):
            for fid in ("09", "10", "11"):
                _touch(root, f"training/image_2/{seq}_{fid}.png")
            for d in ("flow_occ", "flow_noc"):
                _touch(root, f"training/{d}/{seq}_10.png")
    elif kind == "kitti_mv":
        for seq in ("000000", "000001"):
            for fid in range(3):
                _touch(root, f"image_2/{seq}_{fid:02d}.png")
    elif kind == "things":
        for group in ("A/0000", "A/0001"):
            for fid in range(3):
                _touch(root, f"TRAIN/{group}/left/{fid:04d}.png")


COLLECTIONS = [
    ("sintel", "Sintel", {"split": "train", "subsplit": "trainval"}),
    ("sintel", "Sintel", {"split": "train", "subsplit": "train"}),
    ("sintel", "Sintel", {"split": "train", "subsplit": "val",
                          "with_flow": False}),
    ("sintel_raw", "SintelRaw", {"n_frames": 3}),
    ("chairs", "Chairs", {"split": "trainval"}),
    ("chairs", "Chairs", {"split": "train", "with_flow": False}),
    ("chairs", "Chairs", {"split": "valid"}),
    ("chairs2", "Chairs2", {"split": "train"}),
    ("kitti", "KITTIFlow", {"split": "train", "n_frames": 3}),
    ("kitti_mv", "KITTIFlowMV", {}),
    ("things", "Things3D", {"split": "train"}),
]


@pytest.mark.parametrize("kind,cls,kwargs", COLLECTIONS,
                         ids=[f"{c[1]}-{i}" for i, c in enumerate(COLLECTIONS)])
def test_collect_samples_matches_jax(tmp_path, kind, cls, kwargs):
    _tree(tmp_path, kind)
    port = getattr(datasets, cls)(str(tmp_path), **kwargs)
    jax_ds = getattr(jax_datasets, cls)(str(tmp_path), **kwargs)
    assert len(port) == len(jax_ds) > 0
    assert port.samples == jax_ds.samples
    both = datasets.ConcatDataset([port, port])
    assert len(both) == 2 * len(port)


def _chairs_cfg(module_config, root, workers):
    with open(os.path.join(REPO, "configs", "chairs_uflow.json")) as f:
        d = json.load(f)
    for entry in d["data"]:
        entry["root_chairs"] = str(root)
    d["train"].update(batch_size=2, workers=workers)
    return module_config(d)


def test_loaders_match_jax_over_two_epochs(tmp_path):
    """chairs_uflow.json's data section (hflip; hue 0.5 and swapped
    channels on the _ph copies) through both packages' ``build_loaders``,
    one worker thread each: the same batches in the same order, bit for
    bit, in both epochs; and another epoch's shuffle differs."""
    pytest.importorskip("PIL")
    import logging

    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(3),
                           n=8, h=32, w=48)
    log = logging.getLogger("test")
    port_train, port_valid = build_loaders(_chairs_cfg(Config, root, 1), log)
    jax_train, jax_valid = jax_build_loaders(_chairs_cfg(JaxConfig, root, 1), log)
    assert len(port_train) == len(jax_train) == 3  # 7 train pairs, drop_last
    assert [len(v) for v in port_valid] == [len(v) for v in jax_valid] == [1]
    orders = []
    for epoch in (0, 1):
        port_train.set_epoch(epoch)
        jax_train.set_epoch(epoch)
        port_batches, jax_batches = list(port_train), list(jax_train)
        assert len(port_batches) == 3
        for a, b in zip(port_batches, jax_batches):
            assert sorted(a) == sorted(
                ["img1", "img2", "img1_ph", "img2_ph", "img1_orgsize",
                 "img2_orgsize", "img1_rpath", "img2_rpath", "target"])
            assert_same(a, b, f"epoch {epoch}")
        orders.append([r for b in port_batches for r in b["img1_rpath"]])
        assert_same(next(iter(port_valid[0])), next(iter(jax_valid[0])), "valid")
    assert orders[0] != orders[1]


def test_loaders_match_jax_with_both_natives(tmp_path, monkeypatch):
    """The same data section through both packages with their native
    libraries on: decode, flip and swap bit for bit, and the ``_ph``
    copies' hue within the JAX library's gap from numpy (its float32
    reciprocal and fused multiply-adds; the port's hue is numpy's, bit for
    bit: ``test_torch_native_io.py``)."""
    monkeypatch.setattr(arflow_tpu.native, "available", JAX_NATIVE)
    monkeypatch.setattr(arflow_tpu_torch.native, "available", PORT_NATIVE)
    assert arflow_tpu.native.available() and arflow_tpu_torch.native.available()
    import logging

    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(4),
                           n=8, h=32, w=48)
    log = logging.getLogger("test")
    port_train, port_valid = build_loaders(_chairs_cfg(Config, root, 1), log)
    jax_train, jax_valid = jax_build_loaders(_chairs_cfg(JaxConfig, root, 1), log)
    for epoch in (0, 1):
        port_train.set_epoch(epoch)
        jax_train.set_epoch(epoch)
        for a, b in zip(list(port_train), list(jax_train)):
            ph = {k: (a.pop(k), b.pop(k)) for k in ("img1_ph", "img2_ph")}
            assert_same(a, b, f"epoch {epoch}")
            for k, (pa, pb) in ph.items():
                assert pa.dtype == pb.dtype == np.float32
                np.testing.assert_allclose(pa, pb, rtol=0, atol=2e-6, err_msg=k)
    assert_same(next(iter(port_valid[0])), next(iter(jax_valid[0])), "valid")


def test_loader_propagates_item_errors():
    class Broken(InMemoryDataset):
        def __getitem__(self, idx):
            if idx == 3:
                raise KeyError("item 3")
            return super().__getitem__(idx)

    samples = [{"x": np.full(2, i, np.float32)} for i in range(6)]
    loader = DataLoader(Broken(samples), batch_size=2, num_workers=3)
    it = iter(loader)
    np.testing.assert_array_equal(next(it)["x"][:, 0], [0, 1])
    with pytest.raises(KeyError, match="item 3"):
        next(it)
