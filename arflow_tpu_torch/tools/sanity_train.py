"""A learning sanity check: supervised MSE training drives the EPE down
(port of ``arflow_tpu/tools/sanity_train.py``).

Trains ``PWCProbFlow(out_channels=(2, 2, 0), feature_norm=True)`` with
the diagonal Gaussian ``MseLoss`` on 8 pairs of 5x5-box-smoothed noise at
128x160 (``RandomState(seed)``) labelled with a (3, 1) px shift: Adam at
5e-4, ``steps`` steps, the loss and EPE printed every 50 steps and at the
last; fails unless the final EPE is below 1.0 px.

The pairs' second frame is the first moved so that their forward flow is
(-3, -1), while the label is (3, 1), as in the JAX tool (``ROADMAP.md``,
queue 3): the EPE shows that the network fits the label. The port keeps
the data and labels for parity.

The unsupervised census objective on such a small static set falls into
its degenerate optimum (all flow pushed out of frame zeroes the masked
census term), a property of the objective, which large datasets and
augmentation avoid; hence the supervised task.

    python -m arflow_tpu_torch.tools.sanity_train [--steps 300] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.tools.bf16_compare import LOSS, LR, build_model
from arflow_tpu_torch.tools.taylor_compare import make_pairs

PRINT_EVERY = 50
EPE_LIMIT = 1.0


def main(steps: int = 300, seed: int = 0, device="cuda") -> float:
    """Train and print; returns the final EPE (before the last update)."""
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import get_loss

    dev = resolve_device(device)
    i1, i2, (dx, dy) = make_pairs(np.random.RandomState(seed), 8)
    img1, img2 = (torch.as_tensor(x, device=dev) for x in (i1, i2))
    want = torch.tensor([dx, dy], dtype=torch.float32, device=dev)
    gt = want.expand(*img1.shape[:3], 2).contiguous()

    model = build_model("f32", dev)
    loss_fn = get_loss(Config(LOSS))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    gen = torch.Generator(device=dev).manual_seed(0)
    epe = None
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        res = model(img1, img2, with_bk=False)
        total = loss_fn(res, gt, generator=gen)["total"]
        total.backward()
        opt.step()
        if i % PRINT_EVERY == 0 or i == steps - 1:
            with torch.no_grad():
                f0 = res["flows_fw"][0][..., :2]
                epe = float(torch.linalg.norm(f0 - want, dim=-1).mean())
            print(f"step {i}: loss {float(total.detach()):.4f} EPE {epe:.3f}", flush=True)
    if not epe < EPE_LIMIT:
        raise AssertionError(f"EPE did not converge: {epe}")
    print("sanity OK")
    return epe


def cli(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return main(args.steps, args.seed, args.device)


if __name__ == "__main__":
    cli()
