"""Census (ternary) transform and census loss (port of
``arflow_tpu/ops/census.py``, the UFlow/DDFlow recipe). NCHW: images
``(B,3,H,W)``, masks ``(B,1,H,W)``.

The 7x7 patches are 49 shifted slices of one zero-padded canvas, channel
``k`` holding tap ``(k // 7, k % 7)``, as the JAX package writes them.

``census_loss_no_penalty`` is the ELBO loss's form: the per-pixel distance
and a weight map, the penalty applied by the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """(B,3,H,W) RGB -> (B,1,H,W), the weighted sum in the input's dtype."""
    r, g, b = GRAY_WEIGHTS
    return image[:, 0:1] * r + image[:, 1:2] * g + image[:, 2:3] * b


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B,1,H,W) -> (B,patch_size**2,H,W) zero-padded SAME patches."""
    h, w = x.shape[-2], x.shape[-1]
    pad = patch_size // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    return torch.cat([xp[:, :, i:i + h, j:j + w]
                      for i in range(patch_size) for j in range(patch_size)],
                     dim=1)


def census_transform(image: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """(B,3,H,W) -> (B,patch_size**2,H,W) soft ternary census."""
    intensities = rgb_to_grayscale(image) * 255.0
    diff = extract_patches(intensities, patch_size) - intensities
    return diff / torch.sqrt(0.81 + diff.square())


def soft_hamming(a: torch.Tensor, b: torch.Tensor, thresh: float = 0.1
                 ) -> torch.Tensor:
    """Soft Hamming distance, summed over the census channels."""
    sq_dist = (a - b).square()
    return (sq_dist / (thresh + sq_dist)).sum(dim=1, keepdim=True)


def zero_mask_border(mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero a border of ``patch_size // 2`` pixels."""
    pad = patch_size // 2
    h, w = mask.shape[-2], mask.shape[-1]
    border = mask.new_zeros((h, w))
    border[pad:h - pad, pad:w - pad] = 1.0
    return mask * border


def abs_robust_loss(diff: torch.Tensor, eps: float = 0.01, q: float = 0.4
                    ) -> torch.Tensor:
    """(|d| + eps)^q."""
    return torch.pow(diff.abs() + eps, q)


def robust_l1(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x + 0.001**2)."""
    return torch.sqrt(x + 0.001**2)


def census_loss(image_a: torch.Tensor, image_b: torch.Tensor,
                mask: torch.Tensor, patch_size: int = 7,
                num_groups: int = 1) -> torch.Tensor:
    """Masked census loss. ``num_groups > 1`` splits the batch into equal
    groups and returns one loss per group, each normalized by its own mask
    sum. The mask sums carry no gradient."""
    hamming = soft_hamming(census_transform(image_a, patch_size),
                           census_transform(image_b, patch_size))
    padded_mask = zero_mask_border(mask, patch_size)
    diff = abs_robust_loss(hamming) * padded_mask
    if num_groups == 1:
        return diff.sum() / (padded_mask.detach().sum() + 1e-6)
    diff_g = diff.reshape(num_groups, -1)
    mask_g = padded_mask.detach().reshape(num_groups, -1)
    return diff_g.sum(dim=1) / (mask_g.sum(dim=1) + 1e-6)


def census_loss_no_penalty(image_a: torch.Tensor, image_b: torch.Tensor,
                           mask: torch.Tensor, patch_size: int = 7,
                           num_groups: int = 1, a_rep: int = 1):
    """Per-pixel soft Hamming distance (B,1,H,W) of the two census
    transforms, and the border-zeroed mask divided by its sum.

    ``num_groups > 1`` splits the batch into equal groups, each weight map
    normalized by its own group's mask sum (both directions of the ELBO
    loss in one batch). ``a_rep > 1``: ``image_a`` holds one image per
    (group, entry) while ``image_b`` and ``mask`` hold ``a_rep`` copies of
    each group, sample-major within the group; ``image_a``'s transform is
    computed once and broadcast over the copies. The mask sums carry no
    gradient."""
    ca = census_transform(image_a, patch_size)
    cb = census_transform(image_b, patch_size)
    if a_rep > 1:
        tail = cb.shape[1:]
        b_small = image_a.shape[0] // num_groups
        ca = ca.reshape((num_groups, 1, b_small) + tail)
        cb = cb.reshape((num_groups, a_rep, b_small) + tail)
        sq_dist = (ca - cb).square()
        hamming = (sq_dist / (0.1 + sq_dist)).sum(dim=3, keepdim=True)
        hamming = hamming.reshape((-1, 1) + tail[1:])
    else:
        hamming = soft_hamming(ca, cb)
    return hamming, _group_normalize(zero_mask_border(mask, patch_size),
                                     num_groups)


def _group_normalize(padded_mask: torch.Tensor, num_groups: int) -> torch.Tensor:
    """mask / (its group's detached sum + 1e-6), groups along the batch."""
    sums = padded_mask.detach().reshape(num_groups, -1).sum(dim=1) + 1e-6
    denom = sums.repeat_interleave(padded_mask.shape[0] // num_groups)
    return padded_mask / denom.view((-1,) + (1,) * (padded_mask.dim() - 1))
