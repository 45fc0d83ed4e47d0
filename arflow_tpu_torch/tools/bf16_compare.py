"""bfloat16 against float32 training, end to end (port of
``arflow_tpu/tools/bf16_compare.py``).

Trains one supervised flow task twice from the same initial weights:
``PWCProbFlow(out_channels=(2, 2, 0), feature_norm=True)`` with the
diagonal Gaussian ``MseLoss`` on 8 pairs of 5x5-box-smoothed noise whose
second frame is the first moved by (3, 1) px (``make_pairs``, as
``tools/sanity_train.py``), Adam at 5e-4, once with ``model.dtype``
float32 and once bfloat16 (parameters and outputs stay float32; the convs
run in bfloat16). Reports:

- both runs' EPE trajectories (every 25 steps and the last);
- the final EPE gap; bfloat16 is safe when its final EPE is at most
  float32's + 0.05 px (one-sided: ending better is safe);
- each trained parameter set evaluated in both dtypes on 4 held-out pairs
  (``RandomState(1)``): max and mean |flow_bf16 - flow_f32| in px, the
  inference precision's own error, free of training noise.

The label (3, 1) is the JAX tool's; the pairs' forward flow is (-3, -1)
(``ROADMAP.md``, queue 3). The port keeps the data and labels for parity.

    python -m arflow_tpu_torch.tools.bf16_compare [--steps 300] [--device cuda]

Prints one JSON line with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.tools.taylor_compare import make_pairs

ACCEPT_THRESHOLD = 0.05
MODEL = {"type": "uflow_prob", "out_channels": [2, 2, 0], "feature_norm": True}
LOSS = {"type": "mse", "w_mse": 1.0, "w_entropy": 0.01, "diag": True,
        "inv_cov": False, "approx_entropy": False, "n_samples": 1,
        "offdiag_reg": 0.0, "align_corners": False}
LR = 5e-4
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def build_model(dtype_name: str, device, state_dict=None) -> torch.nn.Module:
    """The tool's ``PWCProbFlow`` in ``dtype_name`` ('f32' or 'bf16') on
    ``device``: weights of seed 0, or ``state_dict``."""
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.models import get_model

    model = get_model(Config(dict(MODEL, dtype=DTYPES[dtype_name])),
                      device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def train_one(dtype_name, img1, img2, gt, dxy, steps, record_every=25,
              state_dict=None, device="cuda", seed=0):
    """``steps`` Adam steps at 5e-4 of the ``MseLoss`` in ``dtype_name``
    from ``state_dict`` (or seed 0's weights), the loss's draws from a
    generator of ``seed``. ``img1``, ``img2`` (B,H,W,3) and ``gt``
    (B,H,W,2) are tensors on ``device``. Returns the trained state_dict and
    the curve [(step, EPE before that step's update)] at every
    ``record_every``-th step and the last."""
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import get_loss

    dev = resolve_device(device)
    model = build_model(dtype_name, dev, state_dict)
    loss_fn = get_loss(Config(LOSS))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    gen = torch.Generator(device=dev).manual_seed(seed)
    want = torch.tensor(dxy, dtype=torch.float32, device=dev)
    curve = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        res = model(img1, img2, with_bk=False)
        total = loss_fn(res, gt, generator=gen)["total"]
        total.backward()
        opt.step()
        if i % record_every == 0 or i == steps - 1:
            with torch.no_grad():
                f0 = res["flows_fw"][0][..., :2]
                curve.append((i, float(torch.linalg.norm(f0 - want, dim=-1).mean())))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, curve


def main(steps: int = 300, device="cuda") -> dict:
    dev = resolve_device(device)
    i1, i2, dxy = make_pairs(np.random.RandomState(0), 8)
    img1, img2 = (torch.as_tensor(x, device=dev) for x in (i1, i2))
    gt = torch.tensor(dxy, dtype=torch.float32, device=dev).expand(
        *img1.shape[:3], 2).contiguous()
    init = build_model("f32", dev).state_dict()

    params_f32, curve_f32 = train_one("f32", img1, img2, gt, dxy, steps,
                                      state_dict=init, device=dev)
    params_bf16, curve_bf16 = train_one("bf16", img1, img2, gt, dxy, steps,
                                        state_dict=init, device=dev)

    # Held-out pairs; each parameter set evaluated in both dtypes.
    h1, h2, _ = make_pairs(np.random.RandomState(1), 4)
    h1, h2 = (torch.as_tensor(x, device=dev) for x in (h1, h2))
    deltas = {}
    for pname, params in (("f32_params", params_f32), ("bf16_params", params_bf16)):
        flows = {}
        for dname in ("f32", "bf16"):
            model = build_model(dname, dev, params)
            with torch.no_grad():
                flows[dname] = model(h1, h2, with_bk=False)["flows_fw"][0][..., :2]
        d = (flows["bf16"] - flows["f32"]).abs()
        deltas[pname] = {"max_px": float(d.max()), "mean_px": float(d.mean())}

    final_f32 = curve_f32[-1][1]
    final_bf16 = curve_bf16[-1][1]
    report = {
        "metric": "bf16_vs_f32_training",
        "steps": steps,
        "final_epe_f32": round(final_f32, 4),
        "final_epe_bf16": round(final_bf16, 4),
        "final_epe_delta": round(abs(final_bf16 - final_f32), 4),
        "epe_curve_f32": curve_f32,
        "epe_curve_bf16": curve_bf16,
        "inference_flow_delta_px": deltas,
        "accept_threshold": ACCEPT_THRESHOLD,
        # One-sided: bf16 ending better than f32 is safe; only a final EPE
        # worse by more than the threshold rejects it.
        "bf16_epe_safe": final_bf16 <= final_f32 + ACCEPT_THRESHOLD,
    }
    print(json.dumps(report))
    return report


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return main(args.steps, args.device)


if __name__ == "__main__":
    cli()
