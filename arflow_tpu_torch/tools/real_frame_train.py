"""Unsupervised training on one photograph-like pair (port of
``arflow_tpu/tools/real_frame_train.py``).

Overfits the ``uflow`` census + smoothness objective (the
``chairs_uflow.json`` recipe) to the pair ``img1.png`` -> ``img2.png`` of
``--frames``, and reports the photometric loss's trajectory and the warp
reconstruction against the identity; the final flow is written as ``.flo``
and as an RGB image. With no ground-truth flow, the checks are the census
data loss falling below its value at the untrained weights and the masked
warp PSNR rising above the identity's.

``--elbo`` trains the probabilistic model (``uflow_prob`` with the
diagonal ELBO) instead and also writes the posterior's entropy map. Do not
expect a good flow from it: from scratch on a single pair the ELBO falls
toward the census objective's out-of-frame degenerate optimum whatever
the ``w_oof`` / ``w_entropy`` weights (a property of the objective, shared
with the reference, whose ELBO configs train on 22k FlyingChairs pairs).
The deterministic mode is the quantitative demo.

    python -m arflow_tpu_torch.tools.real_frame_train --frames DIR \\
        [--steps 300] [--size 384x640] [--out DIR] [--dtype bf16] [--elbo] \\
        [--device cuda]

``DIR`` holds ``img1.png`` and ``img2.png``; the tests generate such frames
(``tests/fixtures/__init__.py:ensure_photo_frames``). The steps run as a
plain loop (all ``--steps`` of them); the loss's draws in ``--elbo`` mode
come from seeded generators. Prints one JSON line, the JAX tool's report.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device

UFLOW_MODEL = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}
UFLOW_LOSS = {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0,
              "smooth_order": 1, "edge_constant": 150.0, "with_bk": True}
ELBO_MODEL = {"type": "uflow_prob", "out_channels": [2, 2, 0],
              "inv_cov": False, "n_pyramids": 1, "mixture_weights": False,
              "feature_norm": True, "level_dropout": 0.0}
# w_oof anchors the single-pair overfit against the census objective's
# out-of-frame degenerate optimum (the shipped multi-sample configs rely on
# the data's variety instead).
ELBO_LOSS = {"type": "uflow_elbo", "edge_asymp": 0.01, "w_smooth": 4.0,
             "edge_constant": 150.0, "with_bk": True,
             "penalty_smooth": "charbonnier", "closed_form_smooth": True,
             "isotropic_smooth": False, "data_loss": ["census"],
             "data_weight": [1.0], "data_penalty": ["abs_robust_loss"],
             "w_entropy": 0.01, "w_oof": 0.5, "w_occ": 0.0, "approx": "diag",
             "inv_cov": False, "cov_supp": 0, "n_components": 1,
             "n_samples": 1, "approx_entropy": False, "offdiag_reg": 0.1,
             "natural_grad": False, "occ_type": "sample"}
TRAIN_SEED = 42  # the ELBO loss's draws during training
EVAL_SEED = 7  # its draws in the evaluations


def load_frames(frames: str | None, h: int, w: int):
    """``img1.png`` and ``img2.png`` of ``frames``, decoded and scaled to
    h x w: two (1, h, w, 3) float32 arrays in [0, 1]."""
    from arflow_tpu_torch.data.datasets import load_image
    from arflow_tpu_torch.data.transforms import Scale

    if frames is None or not os.path.exists(os.path.join(frames, "img1.png")):
        raise FileNotFoundError(
            f"no img1.png in --frames {frames!r}: pass --frames DIR, a "
            "directory holding img1.png and img2.png")
    scale = Scale((h, w))
    return tuple(scale(load_image(os.path.join(frames, name)))[None]
                 for name in ("img1.png", "img2.png"))


def psnr(mse) -> float:
    return float(10 * np.log10(1.0 / max(float(mse), 1e-12)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", default=None,
                        help="directory holding img1.png and img2.png")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--size", default="384x640")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "real_frame_demo"))
    parser.add_argument("--dtype", default=None, choices=[None, "bf16"])
    parser.add_argument(
        "--elbo", action="store_true",
        help="train the probabilistic model (uflow_prob + diag ELBO) and "
             "write the posterior entropy map beside the flow")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import get_loss
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.models.uflow import to_nchw
    from arflow_tpu_torch.ops.warp import flow_to_warp, resample
    from arflow_tpu_torch.utils.flow_io import write_flo
    from arflow_tpu_torch.utils.viz import np_flow2rgb

    h, w = (int(x) for x in args.size.split("x"))
    dev = resolve_device(args.device)
    img1, img2 = (torch.as_tensor(x, device=dev)
                  for x in load_frames(args.frames, h, w))
    model_cfg, loss_cfg = ((ELBO_MODEL, ELBO_LOSS) if args.elbo
                           else (UFLOW_MODEL, UFLOW_LOSS))
    dtype = {"dtype": args.dtype} if args.dtype else {}
    model = get_model(Config(dict(model_cfg, **dtype)), device=dev, seed=0)
    loss = get_loss(Config(loss_cfg))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    def call_loss(res, gen):
        if args.elbo:
            return loss(res, img1, img2, generator=gen)
        return loss(res, img1, img2)

    def eval_pair():
        with torch.no_grad():
            res = model(img1, img2, with_bk=True)
            flow = res["flows_fw"][0][..., 0:2]
            warped = resample(to_nchw(img2), flow_to_warp(to_nchw(flow)))
            mse_warp = (warped - to_nchw(img1)).square().mean()
            mse_id = (img2 - img1).square().mean()
            out = call_loss(res, torch.Generator(device=dev).manual_seed(EVAL_SEED))
            entropy = res["flows_fw"][0][..., 2:4] if args.elbo else None
        return flow, out["total"], out["l_ph"], mse_warp, mse_id, entropy

    # The untrained weights' reference point.
    _, _, lph_init, mse_w0, mse_id, _ = eval_pair()

    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    losses = []
    for _ in range(args.steps):
        opt.zero_grad(set_to_none=True)
        total = call_loss(model(img1, img2, with_bk=True), gen)["total"]
        total.backward()
        opt.step()
        losses.append(total.detach())
    losses = torch.stack(losses).cpu().numpy()

    flow, _, lph_fin, mse_w1, _, entropy = eval_pair()
    flow_np = flow[0].cpu().numpy()

    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    write_flo(os.path.join(args.out, "img1_img2.flo"), flow_np)
    rgb = (np_flow2rgb(flow_np) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(os.path.join(args.out, "img1_img2_flow.png"))
    if entropy is not None:
        ent = entropy[0].mean(dim=-1).cpu().numpy()  # (H, W) log-std
        np.save(os.path.join(args.out, "img1_img2_entropy.npy"), ent)
        lo, hi = np.percentile(ent, [2, 98])
        ent8 = np.clip((ent - lo) / max(hi - lo, 1e-9), 0, 1)
        Image.fromarray((ent8 * 255).astype(np.uint8)).save(
            os.path.join(args.out, "img1_img2_entropy.png"))

    report = {
        "metric": "real_frame_unsupervised_train",
        "frames": os.path.abspath(args.frames),
        "size": f"{h}x{w}",
        "steps": len(losses),
        "loss_first": round(float(losses[0]), 4),
        "loss_last": round(float(np.mean(losses[-10:])), 4),
        "census_lph_init": round(float(lph_init), 4),
        "census_lph_final": round(float(lph_fin), 4),
        "warp_psnr_identity": round(psnr(mse_id), 2),
        "warp_psnr_init": round(psnr(mse_w0), 2),
        "warp_psnr_trained": round(psnr(mse_w1), 2),
        "mean_abs_flow_px": round(float(np.mean(np.abs(flow_np))), 2),
        "elbo": bool(args.elbo),
        "out": args.out,
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
