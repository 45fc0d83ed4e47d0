"""UFlow ELBO loss (port of ``arflow_tpu/losses/uflow_elbo.py``): the
negative ELBO of a variational posterior over the level-2 flow.

The network predicts the posterior; the loss draws ``n_samples``
reparametrized flows from it and sums a data term (census on the sampled
flows), smoothness (in closed form for a diagonal posterior, else on the
samples), minus the entropy, plus optional out-of-frame and occlusion
penalties. Posteriors (``cfg.approx``):

- ``diag``: diagonal Gaussian, a log-std (or with ``inv_cov`` a
  log-precision square root) per flow channel;
- ``sparse``: a lower-triangular square root with ``cov_supp``-support
  bands (``ops/triag.py:matrix_vector_product_general``);
- ``mixture``: K diagonal components, with ``res["weights_fw"]`` /
  ``["weights_bw"]`` where the model predicts them, else uniform;
- ``lowrank``: ``columns`` columns of a low-rank square root.

Tensors are NHWC, as the model returns them. Draws come from
``generator``, or from ``noise``, a dict with the JAX loss's keys and
shapes: ``eps12`` / ``eps21`` (n*B, h, w, 2) standard normals, for
``lowrank`` (n*B, 1, 1, 2*columns), and for ``mixture`` ``z12`` / ``z21``
(B, n) component indices. The mixture's components are drawn with
``torch.multinomial`` on the weights; a row of non-finite weights (a
non-finite step, which ``train.nan_revert`` discards) draws uniformly
instead of raising, as ``jax.random.categorical`` draws without raising.
Under ``parallel.data_parallel`` the noise is the global batch's (drawn,
or injected at that shape), the components are drawn on the global batch's
weights, each rank keeps its rows, and every mean and sum runs over the
global batch: each rank's loss is the global batch's.

As the JAX loss does: the closed-form smoothness reads the un-tiled image,
and with ``isotropic_smooth`` the smoothness mean pairs every batch entry's
weights with every entry's penalties (the reference's (B, B, H, W')
broadcast) unless ``fix_isotropic_broadcast`` is set. It raises where the
JAX loss raises (``sparse`` with ``inv_cov``, ``mixture`` with
``inv_cov``, ``natural_grad``, ``closed_form_smooth`` without ``diag``);
it raises when it is built, where the JAX loss raises when called. An
``ssim`` data term is its two distances, each penalized and summed.
``taylor_warp`` (or ``ARFLOW_TAYLOR_WARP=1``, read at each call) warps the
samples of the bidirectional data term by the Taylor warp
(``losses/blocks.py:taylor_warp_enabled``), a mixture's around the drawn
components.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.losses.blocks import (
    data_loss_no_penalty,
    data_loss_no_penalty_bidir,
    edge_weights,
    smooth_loss_no_penalty,
)
from arflow_tpu_torch.models.uflow import to_nchw, to_nhwc
from arflow_tpu_torch.ops import downsample
from arflow_tpu_torch.ops.penalties import get_penalty
from arflow_tpu_torch.ops.triag import matrix_vector_product_general
from arflow_tpu_torch.parallel.mesh import (
    batch_mean,
    batch_sum,
    gather_rows,
    local_rows,
    world_size,
)
from arflow_tpu_torch.utils.gmm import gaussian_mixture_log_pdf


def _drawable(weights: torch.Tensor) -> torch.Tensor:
    """``weights`` (B, K), with each row that holds a non-finite value
    replaced by uniform weights."""
    ok = torch.isfinite(weights).all(dim=1, keepdim=True)
    uniform = torch.full_like(weights, 1.0 / weights.shape[1])
    return torch.where(ok, weights, uniform)


def _tile(x, n):
    """The batch tiled n times, sample-major."""
    return x if n == 1 else x.repeat((n,) + (1,) * (x.dim() - 1))


class UFlowElboLoss:
    def __init__(self, cfg):
        self.cfg = cfg
        _refuse(cfg)

    def _penalty(self, name, kind):
        """kind: 'smooth' or a data-loss name ('census')."""
        if name == "gmm":
            return get_penalty(name, pi=self.cfg.get(f"penalty_{kind}_pi"),
                               beta=self.cfg.get(f"penalty_{kind}_beta"))
        return get_penalty(name)

    # -- reparametrizations ---------------------------------------------------

    def _reparam_triag(self, mean, std_full, eps):
        return mean + matrix_vector_product_general(std_full, eps,
                                                    k=self.cfg.cov_supp)

    @staticmethod
    def _reparam_gmm(mean, std, z, eps):
        """mean/std (B,H,W,2K); z (B,S) component indices; eps (S*B,H,W,2)."""
        b, h, w, _ = mean.shape
        # Sample-major: sample s of entry i is row s*B + i.
        zs = z.t().reshape(-1)
        idx = torch.stack([2 * zs, 2 * zs + 1], dim=-1).view(-1, 1, 1, 2)
        idx = idx.expand(-1, h, w, 2)
        s = z.shape[1]
        return (_tile(mean, s).gather(-1, idx)
                + _tile(std, s).gather(-1, idx) * eps)

    @staticmethod
    def _reparam_lowrank(mean, std, eps_cols):
        """std (S*B,H,W,2C); eps_cols (S*B,1,1,2C), one draw per column."""
        eps = std * eps_cols
        return mean + torch.cat([eps[..., 0::2].sum(-1, keepdim=True),
                                 eps[..., 1::2].sum(-1, keepdim=True)], dim=-1)

    # -- main -----------------------------------------------------------------

    def __call__(self, res_dict, im1_0, im2_0, generator=None, noise=None):
        """``res_dict['flows_fw'/'flows_bw']`` (NHWC, finest first) and the
        NHWC images -> {'total', 'l_ph', 'l_sm', 'entropy', 'l_oof',
        'flow12_2', 'occu_mask12', 'valid_mask12'}, the terms as 0-d
        tensors."""
        cfg = self.cfg
        n = cfg.n_samples
        out_fw = res_dict["flows_fw"][2]
        out_bw = res_dict["flows_bw"][2]
        b, h2, w2 = out_fw.shape[:3]
        noise = noise or {}

        def draw_from():
            if generator is None:
                raise ValueError("UFlowElboLoss draws from a torch.Generator: "
                                 "pass generator= (or every draw in noise=)")
            return generator

        def normal(name, shape):
            # The global batch's draw (sample-major), of which this rank
            # keeps its rows.
            shape = (n * b * world_size(),) + shape[1:]
            if name in noise:
                return local_rows(noise[name], n)
            return local_rows(torch.randn(shape, generator=draw_from(),
                                          dtype=out_fw.dtype,
                                          device=out_fw.device), n)

        loss_offdiag = out_fw.new_zeros(())
        if cfg.approx == "diag":
            mean12_2, log_diag12_2 = out_fw[..., 0:2], out_fw[..., 2:4]
            mean21_2, log_diag21_2 = out_bw[..., 0:2], out_bw[..., 2:4]
            diag12_2, diag21_2 = torch.exp(log_diag12_2), torch.exp(log_diag21_2)
        elif cfg.approx == "sparse":
            num_offdiag = (cfg.cov_supp + 1) ** 2 - 1
            mean12_2, log_diag12_2 = out_fw[..., 0:2], out_fw[..., 2:4]
            mean21_2, log_diag21_2 = out_bw[..., 0:2], out_bw[..., 2:4]
            offdiag12_2 = out_fw[..., 4:4 + num_offdiag * 2]
            offdiag21_2 = out_bw[..., 4:4 + num_offdiag * 2]
            diag12_2, diag21_2 = torch.exp(log_diag12_2), torch.exp(log_diag21_2)
            full12_2 = torch.cat([diag12_2, offdiag12_2], dim=-1)
            full21_2 = torch.cat([diag21_2, offdiag21_2], dim=-1)
            loss_offdiag = batch_mean(offdiag12_2.square())
            if cfg.with_bk:
                loss_offdiag = loss_offdiag + batch_mean(offdiag21_2.square())
        elif cfg.approx == "mixture":
            k = cfg.n_components
            mean12_2, log_diag12_2 = out_fw[..., 0:2 * k], out_fw[..., 2 * k:4 * k]
            mean21_2, log_diag21_2 = out_bw[..., 0:2 * k], out_bw[..., 2 * k:4 * k]
            diag12_2, diag21_2 = torch.exp(log_diag12_2), torch.exp(log_diag21_2)
            if "weights_fw" in res_dict:
                weights12, weights21 = res_dict["weights_fw"], res_dict["weights_bw"]
            else:
                weights12 = weights21 = out_fw.new_ones((b, k)) / k
        else:  # lowrank
            cols = cfg.columns
            mean12_2, std12_2 = out_fw[..., 0:2], out_fw[..., 2:2 + 2 * cols]
            mean21_2, std21_2 = out_bw[..., 0:2], out_bw[..., 2:2 + 2 * cols]

        # -- reparametrization --------------------------------------------
        flow_shape = (n * b, h2, w2, 2)
        z12 = z21 = None
        if cfg.approx == "diag":
            eps12, eps21 = normal("eps12", flow_shape), normal("eps21", flow_shape)
            sign = -1.0 if cfg.inv_cov else 1.0
            flow12_2 = (_tile(mean12_2, n)
                        + torch.exp(sign * _tile(log_diag12_2, n)) * eps12)
            flow21_2 = (_tile(mean21_2, n)
                        + torch.exp(sign * _tile(log_diag21_2, n)) * eps21)
        elif cfg.approx == "sparse":
            eps12, eps21 = normal("eps12", flow_shape), normal("eps21", flow_shape)
            flow12_2 = self._reparam_triag(_tile(mean12_2, n), _tile(full12_2, n), eps12)
            flow21_2 = self._reparam_triag(_tile(mean21_2, n), _tile(full21_2, n), eps21)
        elif cfg.approx == "mixture":
            eps12, eps21 = normal("eps12", flow_shape), normal("eps21", flow_shape)
            if "z12" in noise:
                z12, z21 = noise["z12"], noise["z21"]
            else:  # drawn on the global batch's weights
                z12 = torch.multinomial(_drawable(gather_rows(weights12)), n,
                                        replacement=True, generator=draw_from())
                z21 = torch.multinomial(_drawable(gather_rows(weights21)), n,
                                        replacement=True, generator=draw_from())
            z12, z21 = local_rows(z12), local_rows(z21)
            flow12_2 = self._reparam_gmm(mean12_2, diag12_2, z12, eps12)
            flow21_2 = self._reparam_gmm(mean21_2, diag21_2, z21, eps21)
        else:  # lowrank
            cols_shape = (n * b, 1, 1, 2 * cfg.columns)
            eps12, eps21 = normal("eps12", cols_shape), normal("eps21", cols_shape)
            flow12_2 = self._reparam_lowrank(_tile(mean12_2, n), _tile(std12_2, n), eps12)
            flow21_2 = self._reparam_lowrank(_tile(mean21_2, n), _tile(std21_2, n), eps21)

        # -- entropy ------------------------------------------------------
        w_ent = cfg.w_entropy
        bk = cfg.with_bk
        if cfg.approx == "diag" and not cfg.inv_cov:
            if cfg.get("approx_entropy", False):
                def approx(flow, mean, diag):
                    tmp = ((flow - _tile(mean, n).detach())
                           / _tile(diag, n).detach())
                    return w_ent * batch_mean((tmp * tmp / 2).sum(-1))
                loss_entropy = approx(flow12_2, mean12_2, diag12_2)
                if bk:
                    loss_entropy = loss_entropy + approx(flow21_2, mean21_2, diag21_2)
            else:
                loss_entropy = w_ent * batch_mean(log_diag12_2.sum(-1))
                if bk:
                    loss_entropy = loss_entropy + w_ent * batch_mean(
                        log_diag21_2.sum(-1))
        elif cfg.approx == "diag":  # inv_cov
            loss_entropy = -w_ent * batch_mean(log_diag12_2.sum(-1))
            if bk:
                loss_entropy = loss_entropy - w_ent * batch_mean(
                    log_diag21_2.sum(-1))
        elif cfg.approx == "sparse":
            loss_entropy = w_ent * batch_mean(log_diag12_2.sum(-1))
            if bk:
                loss_entropy = loss_entropy + w_ent * batch_mean(
                    log_diag21_2.sum(-1))
        elif cfg.approx == "mixture":
            loss_entropy = -w_ent * batch_mean(gaussian_mixture_log_pdf(
                flow12_2, mean12_2, log_diag12_2, weights12))
            if bk:
                loss_entropy = loss_entropy - w_ent * batch_mean(
                    gaussian_mixture_log_pdf(flow21_2, mean21_2, log_diag21_2,
                                             weights21))
        else:  # lowrank
            loss_entropy = w_ent * batch_mean(_lowrank_entropy(std12_2))
            if bk:
                loss_entropy = loss_entropy + w_ent * batch_mean(
                    _lowrank_entropy(std21_2))

        # -- data term ----------------------------------------------------
        data_penalties = [self._penalty(name, kind)
                          for name, kind in zip(cfg.data_penalty, cfg.data_loss)]
        if bk:
            nb = flow12_2.shape[0]
            pl, pw, occu_mask_b, valid_mask_b = data_loss_no_penalty_bidir(
                im1_0, im2_0, flow12_2, flow21_2, cfg.occ_type, cfg.data_loss,
                mean12_2, mean21_2, n_rep=n,
                taylor_default=cfg.get("taylor_warp", False), z12=z12, z21=z21)
            occu_mask12 = None if occu_mask_b is None else occu_mask_b[:nb]
            occu_mask21 = None if occu_mask_b is None else occu_mask_b[nb:]
            valid_mask12 = valid_mask_b[:nb]
        else:
            pl, pw, occu_mask12, valid_mask12 = data_loss_no_penalty(
                _tile(im1_0, n), _tile(im2_0, n), flow12_2, flow21_2,
                cfg.occ_type, cfg.data_loss, _tile(mean12_2, n),
                _tile(mean21_2, n))
        loss_warp = out_fw.new_zeros(())
        for pixel_loss, pixel_weight, weight, penalty in zip(
                pl, pw, cfg.data_weight, data_penalties):
            for pl in (pixel_loss if isinstance(pixel_loss, list)
                       else [pixel_loss]):
                loss_warp = loss_warp + batch_sum(pixel_weight * weight
                                                  * penalty(pl))

        # -- smoothness ---------------------------------------------------
        penalty_smooth = self._penalty(cfg.penalty_smooth, "smooth")
        if cfg.get("closed_form_smooth", False):
            loss_smooth = self._closed_form_smooth(im1_0, mean12_2, diag12_2,
                                                   penalty_smooth)
            if bk:
                loss_smooth = loss_smooth + self._closed_form_smooth(
                    im2_0, mean21_2, diag21_2, penalty_smooth)
        else:
            loss_smooth = self._sampled_smooth(_tile(im1_0, n), flow12_2,
                                               penalty_smooth)
            if bk:
                loss_smooth = loss_smooth + self._sampled_smooth(
                    _tile(im2_0, n), flow21_2, penalty_smooth)

        # -- out-of-frame and occlusion penalties -------------------------
        loss_oof = out_fw.new_zeros(())
        if cfg.get("w_oof", 0.0) > 0.0:
            loss_oof = cfg.w_oof * _oof_penalty(flow12_2)
            if bk:
                loss_oof = loss_oof + cfg.w_oof * _oof_penalty(flow21_2)
        loss_occ = 0.0
        if cfg.get("w_occ", 0.0) > 0.0:
            loss_occ = cfg.w_occ * batch_mean(
                _occu_penalty(occu_mask12) * flow12_2.square())
            if bk:
                loss_occ = loss_occ + cfg.w_occ * batch_mean(
                    _occu_penalty(occu_mask21) * flow21_2.square())

        total = loss_warp + loss_smooth - loss_entropy + loss_oof + loss_occ
        if cfg.approx == "sparse":
            total = total + cfg.offdiag_reg * loss_offdiag
        return {"total": total, "l_ph": loss_warp, "l_sm": loss_smooth,
                "entropy": loss_entropy, "l_oof": loss_oof,
                "flow12_2": flow12_2, "occu_mask12": occu_mask12,
                "valid_mask12": valid_mask12}

    # -- smoothness -----------------------------------------------------------

    def _closed_form_smooth(self, im_0, mean_2, diag_2, penalty_func):
        """Expected smoothness under a diagonal posterior, orders 1 and 2."""
        cfg = self.cfg
        im_2 = to_nhwc(downsample(to_nchw(im_0), is_flow=False, scale_factor=4.0))
        order = cfg.get("order_smooth", 1)
        weights_x, weights_y = edge_weights(im_2, cfg.edge_constant,
                                            cfg.edge_asymp,
                                            stride=2 if order == 2 else 1)
        m, d2 = mean_2, diag_2.square()
        if order == 1:
            weights_x, weights_y = weights_x / 2.0, weights_y / 2.0
            e_x = ((m[:, :, 1:] - m[:, :, :-1]) ** 2
                   + d2[:, :, 1:] + d2[:, :, :-1])
            e_y = ((m[:, 1:] - m[:, :-1]) ** 2 + d2[:, 1:] + d2[:, :-1])
        elif order == 2:
            e_x = ((m[:, :, :-2] - 2 * m[:, :, 1:-1] + m[:, :, 2:]) ** 2
                   + d2[:, :, :-2] + 4 * d2[:, :, 1:-1] + d2[:, :, 2:])
            e_y = ((m[:, :-2] - 2 * m[:, 1:-1] + m[:, 2:]) ** 2
                   + d2[:, :-2] + 4 * d2[:, 1:-1] + d2[:, 2:])
        else:
            raise NotImplementedError(f"order_smooth {order}")
        return (self._weighted_smooth_mean(weights_x, e_x, penalty_func)
                + self._weighted_smooth_mean(weights_y, e_y, penalty_func))

    def _sampled_smooth(self, im_0, flow_2, penalty_func):
        """Smoothness of the sampled flows: order 1, averaged over pixels."""
        cfg = self.cfg
        sx, wx, sy, wy = smooth_loss_no_penalty(im_0, flow_2, cfg.edge_constant,
                                                cfg.edge_asymp)
        return (self._weighted_smooth_mean(wx, sx**2, penalty_func)
                + self._weighted_smooth_mean(wy, sy**2, penalty_func))

    def _weighted_smooth_mean(self, weights, e, penalty_func):
        """mean(weights * w_smooth * penalty(e)). With ``isotropic_smooth``
        the penalty takes the channel mean of ``e``, and, unless
        ``fix_isotropic_broadcast``, the mean runs over the (B, B, H, W')
        cross product of weights and penalties, as the reference's
        broadcast has it: mean_hw(mean_b weights * mean_b penalties)."""
        cfg = self.cfg
        if not cfg.get("isotropic_smooth", False):
            return batch_mean(weights * cfg.w_smooth * penalty_func(e))
        q = cfg.w_smooth * penalty_func(e.mean(-1))  # (B, H, W')
        if cfg.get("fix_isotropic_broadcast", False):
            return batch_mean(weights[..., 0] * q)
        return (batch_mean(weights[..., 0], dim=0)
                * batch_mean(q, dim=0)).mean()


def _refuse(cfg):
    """Raise, at construction, on what the JAX loss raises on when called."""
    if cfg.get("natural_grad", False):
        raise NotImplementedError(
            "Natural gradient is not implemented! (nor in the JAX package)")
    if cfg.approx not in ("diag", "sparse", "mixture", "lowrank"):
        raise NotImplementedError(cfg.approx)
    if cfg.approx == "sparse" and cfg.inv_cov:
        raise NotImplementedError(
            "Sparse precision matrix representation is not implemented! (nor "
            "in the JAX package; ROADMAP.md queue 3, 'the sparse precision "
            "ELBO')")
    if cfg.approx == "mixture" and cfg.inv_cov:
        raise NotImplementedError(
            "Inverse covariance parametrization is not implemented for "
            "mixture variational approximation.")
    if cfg.get("closed_form_smooth", False) and cfg.approx != "diag":
        raise NotImplementedError("closed_form_smooth requires diag approximation")


def _occu_penalty(x, alpha=100.0):
    return 1.0 / (alpha * x + 1.0)


def _oof_penalty(flow_2):
    """Quadratic penalty on warp coordinates outside the frame."""
    h, w = flow_2.shape[1], flow_2.shape[2]
    ys = torch.arange(h, dtype=flow_2.dtype, device=flow_2.device).view(1, h, 1)
    xs = torch.arange(w, dtype=flow_2.dtype, device=flow_2.device).view(1, 1, w)
    u, v = flow_2[..., 0] + xs, flow_2[..., 1] + ys
    loss_u = u.clamp_max(0.0) ** 2 + (u - (w - 1.0)).clamp_min(0.0) ** 2
    loss_v = v.clamp_max(0.0) ** 2 + (v - (h - 1.0)).clamp_min(0.0) ** 2
    return batch_mean(loss_u + loss_v)


def _lowrank_entropy(std):
    """Log-determinant entropy of a low-rank square root (B,H,W,2C), per
    image: (log det G_u + log det G_v) / (2 H W), G the C x C Gram matrix of
    the columns of each flow channel."""
    b, h, w, c2 = std.shape
    c = c2 // 2
    std_u = std[..., 0::2].permute(0, 3, 1, 2).reshape(b, c, h * w)
    std_v = std[..., 1::2].permute(0, 3, 1, 2).reshape(b, c, h * w)
    _, logdet_u = torch.linalg.slogdet(std_u @ std_u.transpose(1, 2))
    _, logdet_v = torch.linalg.slogdet(std_v @ std_v.transpose(1, 2))
    return (logdet_u + logdet_v) / (2.0 * h * w)
