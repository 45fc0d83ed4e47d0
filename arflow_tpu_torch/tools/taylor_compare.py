"""Taylor-warp against exact-warp ELBO training (port of
``arflow_tpu/tools/taylor_compare.py``).

Trains one unsupervised task twice from the same initial weights: the
diagonal ELBO (census data term, occ 'mean', 4 samples, the setting whose
per-sample warps the Taylor warp replaces) of ``uflow_prob`` on
smoothed-noise pairs with a known (3, 1) px shift, first with the exact
warp, then with ``ARFLOW_TAYLOR_WARP=1``. Adam at 2e-4; the EPE every 25
steps. Prints one JSON line: both EPE trajectories, the final gap and
whether it lies within the 0.05 px band.

The JAX tool's EPE (``epe_exact``, ``epe_taylor``, ``final_delta_px``,
``ok``, kept here for parity) is taken against (dx, dy) = (3, 1), but its
pairs have img2(y, x) = img1(y + 1, x + 3), so that img1(p) = img2(p + f)
holds for the forward flow f = (-dx, -dy): a model that learns the shift
reads an EPE of |(-6, -2)| = 6.32 px there. ``epe_true_exact``,
``epe_true_taylor`` and ``final_delta_true_px`` are taken against
(-dx, -dy).

    python -m arflow_tpu_torch.tools.taylor_compare [--steps 300] [--device cuda]

The draws (the images' noise, the weights, the loss's samples) come from
seeded generators, so both runs see the same data, weights and noise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device

ACCEPT_BAND_PX = 0.05
RECORD_EVERY = 25
MODEL = {"type": "uflow_prob", "out_channels": [2, 2, 0], "inv_cov": False,
         "n_pyramids": 1, "mixture_weights": False, "feature_norm": True,
         "level_dropout": 0.0}
LOSS = {"type": "uflow_elbo", "edge_asymp": 0.01, "w_smooth": 4.0,
        "edge_constant": 150.0, "with_bk": True,
        "penalty_smooth": "charbonnier", "closed_form_smooth": False,
        "isotropic_smooth": False, "data_loss": ["census"],
        "data_weight": [1.0], "data_penalty": ["abs_robust_loss"],
        "w_entropy": 0.1, "w_oof": 0.0, "w_occ": 0.0, "approx": "diag",
        "n_components": 1, "inv_cov": False, "approx_entropy": False,
        "occ_type": "mean", "n_samples": 4, "offdiag_reg": 0.1,
        "natural_grad": False}


def make_pairs(rng, n, h=128, w=160, dx=3.0, dy=1.0):
    """``n`` pairs of 5x5-box-smoothed noise (NHWC float32), the second
    the first shifted by (dx, dy) px; returns (img1, img2, (dx, dy))."""
    from scipy.ndimage import convolve

    k = np.ones((5, 5)) / 25.0
    p1, p2 = [], []
    for _ in range(n):
        base = rng.rand(h + 2, w + 4, 3).astype(np.float32)
        base = np.stack([convolve(base[..., c], k) for c in range(3)], -1)
        p1.append(base[:h, :w])
        p2.append(base[1:h + 1, 3:w + 3])
    return np.stack(p1), np.stack(p2), (dx, dy)


def train_one(taylor: str, img1, img2, dxy, steps: int, device="cuda") -> list:
    """``steps`` Adam steps of the ELBO with ``ARFLOW_TAYLOR_WARP=taylor``
    ("0" or "1"), from the weights of seed 0 and the loss's draws from
    seed 7; the EPEs against ``dxy`` (the JAX tool's) and against the true
    flow ``-dxy`` after every RECORD_EVERY-th step and after the last, as
    two lists."""
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import get_loss
    from arflow_tpu_torch.models import get_model

    os.environ["ARFLOW_TAYLOR_WARP"] = taylor
    dev = resolve_device(device)
    model = get_model(Config(MODEL), device=dev, seed=0)
    loss = get_loss(Config(LOSS))
    a, b = (torch.as_tensor(x, device=dev) for x in (img1, img2))
    gt = torch.tensor(dxy, dtype=torch.float32, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4)
    gen = torch.Generator(device=dev).manual_seed(7)

    def epes() -> list:
        with torch.no_grad():
            flow = model(a, b, with_bk=False)["flows_fw"][0][..., :2]
            return [round(float(torch.linalg.norm(flow - want, dim=-1).mean()), 4)
                    for want in (gt, -gt)]

    traj, traj_true = [], []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        total = loss(model(a, b, with_bk=True), a, b, generator=gen)["total"]
        total.backward()
        opt.step()
        if not torch.isfinite(total):
            raise FloatingPointError(f"non-finite loss at step {i + 1}")
        if (i + 1) % RECORD_EVERY == 0 or i + 1 == steps:
            epe, epe_true = epes()
            traj.append(epe)
            traj_true.append(epe_true)
    return traj, traj_true


def compare(steps: int = 300, device="cuda") -> dict:
    """Both runs on the tool's 4 pairs; the JSON line's dict. The
    environment's ``ARFLOW_TAYLOR_WARP`` is restored afterwards."""
    img1, img2, dxy = make_pairs(np.random.RandomState(0), 4)
    before = os.environ.get("ARFLOW_TAYLOR_WARP")
    try:
        t_exact, true_exact = train_one("0", img1, img2, dxy, steps, device)
        t_taylor, true_taylor = train_one("1", img1, img2, dxy, steps, device)
    finally:
        if before is None:
            os.environ.pop("ARFLOW_TAYLOR_WARP", None)
        else:
            os.environ["ARFLOW_TAYLOR_WARP"] = before
    delta = abs(t_exact[-1] - t_taylor[-1])
    return {"metric": "taylor_warp_epe_compare", "epe_exact": t_exact,
            "epe_taylor": t_taylor, "final_delta_px": round(delta, 4),
            "accept_band_px": ACCEPT_BAND_PX, "ok": bool(delta <= ACCEPT_BAND_PX),
            "epe_true_exact": true_exact, "epe_true_taylor": true_taylor,
            "final_delta_true_px": round(abs(true_exact[-1] - true_taylor[-1]), 4),
            "steps": steps, "device": str(device)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(compare(args.steps, args.device)))


if __name__ == "__main__":
    main()
