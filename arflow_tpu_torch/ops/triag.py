"""Banded triangular solves over the image lattice and their adjoints
(port of ``arflow_tpu/ops/triag.py``).

The lower-triangular matrix L couples each pixel to its left (B), upper (C)
and upper-left (D) neighbours, besides itself (A). Tensors are NHWC with
reduced band extents: A (B,M,N,C), B (B,M,N-1,C), C (B,M-1,N,C),
D (B,M-1,N-1,C).

The solve runs as a wavefront over the M+N-1 anti-diagonals: diagonal d
needs only diagonals d-1 and d-2. Every band is first skewed to
diagonal-major layout (one pad and reshape), so that each step works on
whole (..., M) slices. The JAX package writes this as a ``lax.scan`` in
XLA, not Pallas, so here it is plain PyTorch, one Python step per
diagonal.

``forward_substitution`` (L y = x) and ``backward_substitution``
(L^T y = x) are ``torch.autograd.Function``s with the JAX package's
analytic adjoints: the gradient of x is one solve of the other triangle on
the incoming gradient, dx, and each band's gradient is -dx * y on that
band's shifted slices. Their only user in training is the ``inv_cov``
posterior of ``MseLoss``, which samples with ``backward_substitution``.

The banded products ``matrix_vector_product*`` (y = L x and y = L^T x,
the general ones with k-support bands) are plain tensor ops that autograd
differentiates: the ``sparse`` ELBO posterior calls the general one, and
``MseLoss`` the other two.

The natural-gradient identities (``natural_gradient_identity_t`` and
``_c``) and the condition estimate ``inverse_l1norm`` are the reference's
unused machinery, kept for parity: no loss calls them, and
``natural_grad: true`` is refused by the ELBO loss in both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_nhwc(x, top=0, bottom=0, left=0, right=0):
    return F.pad(x, (0, 0, left, right, top, bottom))


def matrix_vector_product(a, b, c, d, x):
    """y = L x with bands |D|C| / |B|A|, NHWC."""
    b_y = _pad_nhwc(b * x[:, :, :-1], left=1)
    c_y = _pad_nhwc(c * x[:, :-1], top=1)
    d_y = _pad_nhwc(d * x[:, :-1, :-1], top=1, left=1)
    return a * x + b_y + c_y + d_y


def matrix_vector_product_T(a, b, c, d, x):
    """y = L^T x, NHWC."""
    b_y = _pad_nhwc(b * x[:, :, 1:], right=1)
    c_y = _pad_nhwc(c * x[:, 1:], bottom=1)
    d_y = _pad_nhwc(d * x[:, 1:, 1:], bottom=1, right=1)
    return a * x + b_y + c_y + d_y


def _band(a, k, i, j):
    """Channels of band (i, j): offset i rows up and j columns left."""
    ind = i * (k + 1) + j
    return a[..., ind * 2:(ind + 1) * 2]


def matrix_vector_product_general(a, x, k: int = 1):
    """y = L x with k-support bands. a: (B, M, N, 2*(k+1)**2), channel
    pairs ordered by band ind = i*(k+1) + j (i rows up, j columns left);
    x: (B, M, N, 2)."""
    y = torch.zeros_like(x)
    m, n = x.shape[1], x.shape[2]
    for i in range(k + 1):
        for j in range(k + 1):
            coeff = _band(a, k, i, j)
            y = y + _pad_nhwc(coeff[:, :m - i, :n - j] * x[:, :m - i, :n - j],
                              top=i, left=j)
    return y


def matrix_vector_product_T_general(a, x, k: int = 1):
    """y = L^T x, the transpose of ``matrix_vector_product_general``."""
    y = torch.zeros_like(x)
    m, n = x.shape[1], x.shape[2]
    for i in range(k + 1):
        for j in range(k + 1):
            coeff = _band(a, k, i, j)
            y = y + _pad_nhwc(coeff[:, :m - i, :n - j] * x[:, i:, j:],
                              bottom=i, right=j)
    return y


def _skew(x: torch.Tensor, num_diags: int) -> torch.Tensor:
    """Diagonal-major reindex: out[..., i, d] = x[..., i, d - i] (else 0).

    x: (..., R, Cc) -> (..., R, num_diags), num_diags >= R + Cc - 1. Row i
    of the padded (R, Cc + R) buffer read with a stride of Cc + R - 1 is
    shifted right by i; what leaves [0, Cc) lands in the zero padding.
    """
    *lead, r, cc = x.shape
    flat = F.pad(x, (0, r)).reshape(*lead, r * (cc + r))
    skewed = flat[..., :r * (cc + r - 1)].reshape(*lead, r, cc + r - 1)
    return F.pad(skewed, (0, num_diags - (cc + r - 1)))


def _unskew(t: torch.Tensor, r: int, cc: int) -> torch.Tensor:
    """Inverse of ``_skew``: out[..., i, j] = t[..., i, j + i]."""
    *lead, _, nd = t.shape
    flat = F.pad(t.reshape(*lead, r * nd), (0, r))
    return flat.reshape(*lead, r, nd + 1)[..., :cc]


def _skewed_bands(a, b, c, d):
    """(..., M, N)-layout bands -> diagonal-major (..., M, M+N-1), aligned
    so that [..., dd] holds what diagonal dd needs: B one diagonal later,
    C and D one row lower and one and two diagonals later. A is 1 outside
    the lattice, so that those lanes divide by 1."""
    *lead, m, n = a.shape
    nd = m + n - 1
    a_sk = _skew(a, nd) + (1.0 - _skew(torch.ones_like(a), nd))
    b_sk = _skew(b, nd - 1) if n > 1 else a.new_zeros((*lead, m, nd - 1))
    c_sk = _skew(c, nd - 1) if m > 1 else a.new_zeros((*lead, 0, nd - 1))
    if m > 1 and n > 1:
        d_sk = _skew(d, nd - 2)
    else:
        d_sk = a.new_zeros((*lead, max(m - 1, 0), nd - 2))
    return (a_sk, F.pad(b_sk, (1, 0)), F.pad(c_sk, (1, 0, 1, 0)),
            F.pad(d_sk, (2, 0, 1, 0)))


def _shift_rows(v: torch.Tensor) -> torch.Tensor:
    """v[..., i] -> v[..., i - 1], zero in row 0."""
    return F.pad(v[..., :-1], (1, 0))


def _wavefront(bands, rhs):
    """Yield the diagonals of y with L y = x, from the skewed ``bands`` and
    ``rhs(dd)``, x's diagonal dd; shapes broadcast."""
    a_sk, b_sk, c_sk, d_sk = bands
    prev1 = prev2 = None
    for dd in range(a_sk.shape[-1]):
        x_d = rhs(dd)
        if prev1 is None:
            shape = torch.broadcast_shapes(x_d.shape, a_sk.shape[:-1])
            prev1 = prev2 = x_d.new_zeros(shape)
        cur = (x_d
               - b_sk[..., dd] * prev1
               - c_sk[..., dd] * _shift_rows(prev1)
               - d_sk[..., dd] * _shift_rows(prev2)) / a_sk[..., dd]
        yield cur
        prev1, prev2 = cur, prev1


def _to_bcmn(t):
    return t.permute(0, 3, 1, 2)


def _lower_solve(a, b, c, d, x):
    """L y = x by the wavefront, NHWC."""
    a, b, c, d, x = (_to_bcmn(t) for t in (a, b, c, d, x))
    m, n = x.shape[-2:]
    x_sk = _skew(x, m + n - 1)
    diags = list(_wavefront(_skewed_bands(a, b, c, d), lambda dd: x_sk[..., dd]))
    return _unskew(torch.stack(diags, dim=-1), m, n).permute(0, 2, 3, 1)


def _upper_solve(a, b, c, d, x):
    """L^T y = x: the lower solve on the lattice flipped along both axes."""
    flip = lambda t: t.flip(1, 2)  # noqa: E731
    return flip(_lower_solve(*(flip(t) for t in (a, b, c, d, x))))


class _ForwardSubstitution(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, d, x):
        y = _lower_solve(a, b, c, d, x)
        ctx.save_for_backward(a, b, c, d, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, c, d, y = ctx.saved_tensors
        dx = _upper_solve(a, b, c, d, dy)
        return (-dx * y, -dx[:, :, 1:] * y[:, :, :-1], -dx[:, 1:] * y[:, :-1],
                -dx[:, 1:, 1:] * y[:, :-1, :-1], dx)


class _BackwardSubstitution(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, d, x):
        y = _upper_solve(a, b, c, d, x)
        ctx.save_for_backward(a, b, c, d, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, c, d, y = ctx.saved_tensors
        dx = _lower_solve(a, b, c, d, dy)
        return (-dx * y, -dx[:, :, :-1] * y[:, :, 1:], -dx[:, :-1] * y[:, 1:],
                -dx[:, :-1, :-1] * y[:, 1:, 1:], dx)


def forward_substitution(a, b, c, d, x):
    """Solve L y = x (lower-triangular, banded), NHWC: A (B,M,N,C), B
    (B,M,N-1,C), C (B,M-1,N,C), D (B,M-1,N-1,C), x (B,M,N,C). Autograd
    takes the analytic adjoint."""
    return _ForwardSubstitution.apply(a, b, c, d, x)


def backward_substitution(a, b, c, d, x):
    """Solve L^T y = x (upper-triangular: B couples the right neighbour, C
    the one below), NHWC, with the analytic adjoint."""
    return _BackwardSubstitution.apply(a, b, c, d, x)


def inverse_diagonal(a, b, c, d=None, chunk: int = 1 << 15):
    """diag((L L^T)^-1) per pixel, NHWC: the marginal variances of
    N(0, (L L^T)^-1). For each pixel p it solves L y = e_p and sums y**2.

    The unit vectors ride a batch axis of their own, ``chunk`` pixels at a
    time, with the bands broadcast over it; each is made one diagonal at a
    time, and only the running sum of y**2 is kept. The result does not
    depend on ``chunk``, only the memory does: about 10 tensors of
    B x chunk x C x M elements.
    """
    bsz, m, n, ch = a.shape
    if d is None:
        d = a.new_zeros((bsz, max(m - 1, 0), max(n - 1, 0), ch))
    bands = [t.unsqueeze(1) for t in
             _skewed_bands(*(_to_bcmn(t) for t in (a, b, c, d)))]
    rows = torch.arange(m, device=a.device)
    sums = []
    for start in range(0, m * n, chunk):
        p = torch.arange(start, min(start + chunk, m * n), device=a.device)
        row_of = (rows == (p // n)[:, None]).to(a.dtype)  # (K, M)
        diag_of = p // n + p % n

        def unit(dd):
            return (row_of * (diag_of == dd).to(a.dtype)[:, None])[None, :, None]

        ss = 0.0
        for y_d in _wavefront(bands, unit):
            ss = ss + (y_d * y_d).sum(dim=-1)
        sums.append(ss)  # (B, K, C)
    return torch.cat(sums, dim=1).reshape(bsz, m, n, ch)


# -- natural gradients and the condition estimate ----------------------------


def natural_gradient(ga, gb, gc, ta, tb, tc):
    """The natural gradient with respect to the 3-band lower factor T of a
    precision matrix, from the Euclidean gradients G. NHWC bands: A
    (B,M,N,C), B (B,M,N-1,C), C (B,M-1,N,C); returns (q_ll, q_l1l, q_lNl)
    in those shapes."""
    h_ll = (ta * ga + _pad_nhwc(tb * gb, right=1)
            + _pad_nhwc(tc * gc, bottom=1)) / 2.0
    h_l1l = ta[:, :, 1:] * gb
    h_lnl = ta[:, 1:] * gc
    h_ln1l = tb[:, 1:] * gc[:, :, 1:]

    q_ll = ta * h_ll
    q_l1l = ta[:, :, 1:] * h_l1l + tb * h_ll[:, :, :-1]
    q_lnl = (ta[:, 1:] * h_lnl + _pad_nhwc(tb[:, 1:] * h_ln1l, left=1)
             + tc * h_ll[:, :-1])
    return q_ll, q_l1l, q_lnl


def _zero_d(a):
    return a.new_zeros((a.shape[0], max(a.shape[1] - 1, 0),
                        max(a.shape[2] - 1, 0), a.shape[3]))


def _or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g


def _precision_mean_grad(a, b, c, d, dx):
    """L^-T L^-1 dx: solved through L, then L^T."""
    return _upper_solve(a, b, c, d, _lower_solve(a, b, c, d, dx))


def _covariance_mean_grad(a, b, c, d, dx):
    """L L^T dx: the banded products, no solves."""
    return matrix_vector_product(a, b, c, d, matrix_vector_product_T(a, b, c, d, dx))


class _NaturalGradientIdentity(torch.autograd.Function):
    """Identity on (a, b, c, x) whose backward maps the bands' gradients
    through ``natural_gradient`` and the mean's through ``mean_grad``."""

    @staticmethod
    def forward(ctx, mean_grad, a, b, c, x):
        ctx.mean_grad = mean_grad
        ctx.save_for_backward(a, b, c)
        return a.view_as(a), b.view_as(b), c.view_as(c), x.view_as(x)

    @staticmethod
    def backward(ctx, da, db, dc, dx):
        a, b, c = ctx.saved_tensors
        da, db, dc = (_or_zeros(g, t) for g, t in ((da, a), (db, b), (dc, c)))
        dx_n = None if dx is None else ctx.mean_grad(a, b, c, _zero_d(a), dx)
        return (None, *natural_gradient(da, db, dc, a, b, c), dx_n)


def natural_gradient_identity_t(a, b, c, x):
    """Identity on (a, b, c, x) whose backward applies the natural
    gradient of the precision parametrization: the mean's gradient is
    solved through L, then L^T; the bands' go through
    ``natural_gradient``."""
    return _NaturalGradientIdentity.apply(_precision_mean_grad, a, b, c, x)


def natural_gradient_identity_c(a, b, c, x):
    """The covariance parametrization's identity: the mean's gradient goes
    through the banded products L^T, then L (no solves); the bands' through
    ``natural_gradient``."""
    return _NaturalGradientIdentity.apply(_covariance_mean_grad, a, b, c, x)


def inverse_l1norm(a, b, c, n_iter: int = 100) -> float:
    """An estimate of ||L^-1||_1 by Higham's algorithm 5.1, for one lattice:
    a (M,N), b (M,N-1), c (M-1,N); ``inf`` when it does not settle within
    ``n_iter`` iterations.

    An eval-only diagnostic (the reference's detector of an exploding
    posterior): a host loop of solves that reads two scalars back per
    iteration. NEVER call it inside a train step: on the card each
    iteration is a device round trip.
    """
    m, n = a.shape
    a4, b4, c4 = (t[None, :, :, None] for t in (a, b, c))
    d4 = a.new_zeros((1, m - 1, n - 1, 1))
    x = torch.ones((m, n), dtype=a.dtype, device=a.device) / (m * n)
    with torch.no_grad():
        for _ in range(n_iter):
            y = _lower_solve(a4, b4, c4, d4, x[None, :, :, None])[0, :, :, 0]
            xi = torch.where(y < 0, -1.0, 1.0).to(a.dtype)
            z = _upper_solve(a4, b4, c4, d4, xi[None, :, :, None])[0, :, :, 0]
            abs_z = z.abs()
            flat_idx = int(abs_z.argmax())
            if float(abs_z.max()) <= float((z * x).sum()):
                return float(y.abs().sum())
            x = torch.zeros((m, n), dtype=a.dtype, device=a.device)
            x[flat_idx // n, flat_idx % n] = 1.0
    return float("inf")
