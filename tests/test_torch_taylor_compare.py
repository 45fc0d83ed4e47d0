"""``tools/taylor_compare.py`` on the CPU at two steps: its two runs
print one JSON line with the JAX tool's keys and the EPE against the
true flow (the JAX tool has no test; its 300 steps run in
``chip_smoke.py``'s ``taylor_warp`` phase)."""

import json
import os

import numpy as np

from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


def test_taylor_compare_two_steps_on_cpu(monkeypatch, capsys):
    """The tool's two runs at 2 steps on the CPU print one JSON line with
    the JAX tool's keys, finite EPEs, and leave the environment as it
    was."""
    from arflow_tpu_torch.tools import taylor_compare

    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    taylor_compare.main(["--steps", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "epe_exact", "epe_taylor", "final_delta_px",
            "accept_band_px", "ok"} <= set(out)
    assert out["metric"] == "taylor_warp_epe_compare"
    assert out["accept_band_px"] == 0.05
    assert len(out["epe_exact"]) == len(out["epe_taylor"]) == 1
    assert np.isfinite(out["epe_exact"] + out["epe_taylor"]).all()
    assert len(out["epe_true_exact"]) == len(out["epe_true_taylor"]) == 1
    assert np.isfinite(out["epe_true_exact"] + out["epe_true_taylor"]).all()
    assert out["ok"] == (out["final_delta_px"] <= 0.05)
    assert os.environ["ARFLOW_TAYLOR_WARP"] == "0"
