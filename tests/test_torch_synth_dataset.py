"""``arflow_tpu_torch/tools/synth_dataset.py`` against the JAX package's
tool: the same seed writes the same bytes (every ``.ppm`` and ``.flo`` of
4 pairs at 32x48), ``smooth_flow`` is equal bit for bit, the port's
``Chairs`` reads back what was written, and the CLI prints the JAX tool's
message. Both tools are numpy; no JAX runs here."""

import os

import numpy as np
import pytest

from arflow_tpu.tools import synth_dataset as jax_synth
from arflow_tpu_torch.tools import synth_dataset
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


@pytest.mark.parametrize("seed,max_flow,start_fid", [(0, 6.0, 1), (3, 2.5, 5)])
def test_generate_chairs_writes_the_jax_bytes(tmp_path, seed, max_flow, start_fid):
    want = jax_synth.generate_chairs(str(tmp_path / "jax"), 4, (32, 48), max_flow,
                                     seed, start_fid)
    got = synth_dataset.generate_chairs(str(tmp_path / "port"), 4, (32, 48),
                                        max_flow, seed, start_fid)
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got))
    assert names == sorted(f"{fid:05d}_{kind}" for fid in range(start_fid, start_fid + 4)
                           for kind in ("img1.ppm", "img2.ppm", "flow.flo"))
    for name in names:
        with open(os.path.join(want, name), "rb") as f_j, \
                open(os.path.join(got, name), "rb") as f_t:
            assert f_t.read() == f_j.read(), name


def test_smooth_flow_equal_bit_for_bit():
    for seed in (0, 1):
        a = synth_dataset.smooth_flow(np.random.RandomState(seed), 24, 40, 3.0)
        b = jax_synth.smooth_flow(np.random.RandomState(seed), 24, 40, 3.0)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).max() == pytest.approx(3.0, rel=1e-6)


def test_written_pairs_read_back_through_chairs(tmp_path):
    """The port's ``Chairs`` reads the written flow as written, bit for
    bit, with the frames in [0, 1] at the written size."""
    from arflow_tpu_torch.data import Chairs
    from arflow_tpu_torch.utils.flow_io import read_flo

    root = synth_dataset.generate_chairs(str(tmp_path), 8, (32, 48), seed=2)
    ds = Chairs(root, split="trainval", with_flow=True)
    assert len(ds) == 8
    for i in (0, 5):
        s = ds[i]
        flow = read_flo(os.path.join(root, f"{i + 1:05d}_flow.flo"))
        np.testing.assert_array_equal(s["target"]["flow"], flow)
        assert s["img1"].shape == (32, 48, 3) and 0 <= s["img1"].min() <= s["img1"].max() <= 1


def test_cli_prints_the_jax_message(tmp_path, capsys):
    argv = ["--n", "2", "--size", "16x24", "--seed", "1", "--max-flow", "2"]
    jax_synth.main(["--root", str(tmp_path / "jax"), *argv])
    want = capsys.readouterr().out
    synth_dataset.main(["--root", str(tmp_path / "jax"), *argv])
    assert capsys.readouterr().out == want == f"wrote 2 pairs at 16x24 to {tmp_path / 'jax'}\n"
    with pytest.raises(SystemExit):
        synth_dataset.main(["--n", "2"])  # --root is required
