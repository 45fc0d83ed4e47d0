"""Synthetic FlyingChairs-format directories for the port's data, checkpoint
and CLI tests: ``{fid:05d}_img{1,2}.ppm`` written with numpy and
``{fid:05d}_flow.flo`` written with the port's ``write_flo``; and the
``few_torch_threads`` fixture that every port test module takes (it
imports no JAX)."""

import numpy as np
import pytest
import torch

from arflow_tpu_torch.ops.resize import resize_bilinear_np
from arflow_tpu_torch.utils.flow_io import write_flo


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """One torch thread per test process while a module runs. The test lane
    runs six workers, the data-parallel tests' rank processes and the JAX
    side's own threads on eight cores: each further torch thread only
    spins at the end of every parallel op, waiting for threads that share
    its core (a loss test file took twice the CPU time with torch's default
    of one thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_ppm(path, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> binary PPM (P6)."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def make_chairs_dir(root, rs, n, h, w):
    """``n`` pairs of noise images with noise flows, fids 1..n, in
    ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    for fid in range(1, n + 1):
        for i in (1, 2):
            write_ppm(root / f"{fid:05d}_img{i}.ppm",
                      (rs.rand(h, w, 3) * 255).astype(np.uint8))
        write_flo(str(root / f"{fid:05d}_flow.flo"),
                  rs.randn(h, w, 2).astype(np.float32))
    return root


def make_shifted_chairs_dir(root, rs, n, h, w):
    """``n`` pairs, fids 1..n, in ``root``: img1 a smooth random texture,
    img2 the same texture moved by a whole (dy, dx) in [-3, 3], and that
    shift, (u, v) = (dx, dy), as the flow."""
    root.mkdir(parents=True, exist_ok=True)
    for fid in range(1, n + 1):
        dy, dx = rs.randint(-3, 4, size=2)
        coarse = rs.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
        tex = resize_bilinear_np(coarse, (h + 8, w + 8))
        img1 = tex[4:4 + h, 4:4 + w]
        img2 = tex[4 - dy:4 - dy + h, 4 - dx:4 - dx + w]
        for i, img in ((1, img1), (2, img2)):
            write_ppm(root / f"{fid:05d}_img{i}.ppm",
                      np.round(img * 255).astype(np.uint8))
        write_flo(str(root / f"{fid:05d}_flow.flo"),
                  np.tile(np.float32([dx, dy]), (h, w, 1)))
    return root
