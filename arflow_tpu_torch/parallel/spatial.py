"""Spatial (image-height) sharding of the UFlow forward and of its training
objective (port of ``arflow_tpu/parallel/spatial.py``).

The JAX package puts the images on a (data, space) mesh with their height
split over ``space`` and lets GSPMD partition the whole ``PWCFlow``
forward, halos included. PyTorch has no partitioner that takes the custom
cost-volume op, so the port writes the halos by hand: each rank of a space
group holds a band of rows of every feature map and computes exactly those
rows of every op's output.

Rows. At every level of height ``h``, space rank ``r`` of ``S`` owns rows
``[floor(r h / S), floor((r + 1) h / S))`` (``row_range``); at a coarse
level a rank may own none. An op that reads rows beyond a rank's band gets
them from ``SpaceAxis.take``: the band plus the global rows ``[lo, hi)`` around
it, with zeros outside the image. Every rank puts its first and last ``k``
rows into one zero-filled buffer that the space group all-reduces (gloo
takes no all-gather of CUDA tensors; a sum with zeros is exact), where
``k`` is the widest reach of any rank's request. A row within ``k`` of a
band's edge lies within ``k`` of its owner's edge too, so one exchange
covers a neighbour thinner than the halo, or one that owns nothing.

The forward (``spatial_forward``), op by op:

- convolutions (pyramid, stride 2 included; decoder; refinement, dilated
  up to 16; the context deconv): the input rows the band's output reads,
  zeros outside the image, then the op without height padding;
- ``upsample`` (bilinear, ``align_corners=False``): the input rows the
  band's output reads, clipped to the image, so that at the image's top
  and bottom the resize clamps to the edge row as the whole image's does;
- ``normalize_features``: each image's sums over (C, H, W) all-reduced
  over the space group, in two passes as the one-process version takes
  its mean and then its variance;
- the cost volume: the kernel ``arflow::cost_volume`` unchanged on each
  band with 4 halo rows of both features (zeros at the image's edge, the
  kernel's own padding), of whose output the rank keeps its band;
- the feature warp: the whole level of the second frame's features
  gathered, as GSPMD does, and sampled at the band's warp coordinates in
  global rows, normalized by the whole level's size.

The JAX ``spatial_apply`` turns its Pallas kernel off under the mesh,
because GSPMD cannot partition an opaque custom call; the port needs no
such switch, since the kernel runs per band (its backward too).

Training (``spatial_value_and_grad``: the JAX package's ``value_and_grad``
of the uflow objective under the mesh) runs the forward with gradients
and ``spatial_uflow_loss``, ``UFlowLoss`` on the bands. Every all-reduce
then follows ``parallel/mesh.py:all_sum``: its backward sums the gradient
over the group, so each rank, which computes the global loss, holds
``mesh.size`` times its share of every gradient, and the backward of each
exchange comes at no extra cost: the rows a rank lent return to their
owner as a sum, the gathered level's gradient is all-reduced and each rank
keeps its rows (a reduce-scatter), and the moments of
``normalize_features`` sum back. One all-reduce of the concatenated
parameter gradients over the mesh, divided by its size, then leaves the
one-process gradient on every rank. gloo pairs all-reduces by the order
they are issued in, and autograd runs a backward in the reverse order of
creation among the nodes it reaches; so in training every exchange joins
the graph on every rank (``mesh.all_sum(force=True)``), and the finest
forward flow and the loss depend on every exchange's output through an
exact zero (``SpaceAxis.tie``), where an empty band would cut it off.
bfloat16 and int8 under a spatial mesh are not ported (``ROADMAP.md``
queue 1, 'parallel'): ``spatial_forward`` refuses them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from arflow_tpu_torch.ops.cost_volume import compute_cost_volume
from arflow_tpu_torch.ops.resize import _resize_matrix, resize_bilinear
from arflow_tpu_torch.ops.warp import flow_to_warp, mask_invalid, resample
from arflow_tpu_torch.parallel.mesh import (Mesh, all_sum, average_grads,
                                            local_device)

SPATIAL_NOT_PORTED = (
    "the spatial forward and its training run PWCFlow in float32 or "
    "float64: bfloat16 and int8 under a spatial mesh are not ported; "
    "ROADMAP.md queue 1, 'parallel'")


def make_spatial_mesh(n_spatial: int | None = None, device=None,
                      ranks=None) -> Mesh | None:
    """A 2-D (data, space) mesh over ``ranks`` (default: every rank of the
    run): ``n_spatial`` ranks split the image height (default: all, pure
    spatial), and the ``len(ranks) // n_spatial`` groups of them split the
    batch. Rank ``ranks[i * n_spatial + j]`` is at (i, j); ``groups`` holds
    this rank's sub-group along each axis. Every rank of the run must call
    it (groups are made collectively); one outside ``ranks`` gets None.
    Without a process group it is the (1, 1) mesh.

    Raises ``ValueError`` where ``n_spatial`` does not divide the ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = sorted(range(world) if ranks is None else ranks)
    n = len(ranks)
    if n_spatial is None:
        n_spatial = n
    if n_spatial <= 0 or n % n_spatial:
        raise ValueError(f"{n} ranks do not factor into (batch, {n_spatial}) "
                         "spatial groups")
    shape, axes = (n // n_spatial, n_spatial), ("data", "space")
    dev = local_device(me) if device is None else torch.device(device)
    if world == 1:
        return Mesh(dev, None, shape, axes)
    # every rank creates every group, in the same order
    group = dist.group.WORLD if n == world else dist.new_group(ranks)
    groups = {}
    for i in range(shape[0]):
        g = dist.new_group(ranks[i * n_spatial:(i + 1) * n_spatial])
        if me in ranks[i * n_spatial:(i + 1) * n_spatial]:
            groups["space"] = g
    for j in range(n_spatial):
        g = dist.new_group(ranks[j::n_spatial])
        if me in ranks[j::n_spatial]:
            groups["data"] = g
    if me not in ranks:
        return None
    return Mesh(dev, group, shape, axes, groups)


def row_range(h: int, n: int, r: int) -> tuple:
    """The rows ``[lo, hi)`` of a level of height ``h`` that rank ``r`` of
    ``n`` owns."""
    return r * h // n, (r + 1) * h // n


def mesh_coords(mesh: Mesh) -> tuple:
    """This rank's (data, space) index on ``mesh``."""
    return divmod(mesh.rank, mesh.shape[1])


def spatial_image_sharding(mesh: Mesh, batch_size: int, height: int) -> list:
    """The layout of NHWC images of ``batch_size`` x ``height`` on ``mesh``
    (the counterpart of the JAX ``NamedSharding``): for each rank of the
    mesh, in rank order, its (batch slice, row slice)."""
    n_data, n_space = mesh.shape
    if batch_size % n_data:
        raise ValueError(f"a batch of {batch_size} does not divide over "
                         f"{n_data} data groups")
    b = batch_size // n_data
    return [(slice(d * b, (d + 1) * b), slice(*row_range(height, n_space, r)))
            for d in range(n_data) for r in range(n_space)]


def shard_images_spatial(mesh: Mesh, *images):
    """This rank's batch part and rows of each NHWC image (arrays or
    tensors), as tensors on the mesh's device."""
    out = []
    for im in images:
        part = spatial_image_sharding(mesh, im.shape[0], im.shape[1])[mesh.rank]
        im = im if torch.is_tensor(im) else torch.from_numpy(np.asarray(im))
        out.append(im[part].to(mesh.device))
    return out[0] if len(out) == 1 else tuple(out)


# -- the halo primitive --------------------------------------------------------

def halo_edges(x: torch.Tensor, h: int, n: int, r: int, k: int) -> torch.Tensor:
    """Rank ``r``'s part of the halo exchange of a level of height ``h``
    split over ``n`` ranks, ``x`` its rows (B,C,rows,W): a zero buffer
    (B,C,2nk+1,W) that holds, in slots ``2r`` and ``2r+1`` of ``k`` rows, its
    first and its last ``min(k, rows)`` rows; the last row stays zero (the
    rows outside the image). The sum of every rank's buffer is what
    ``halo_take`` reads."""
    b, c, rows, w = x.shape
    lo, hi = row_range(h, n, r)
    if rows != hi - lo:
        raise ValueError(f"rank {r} of {n} owns {hi - lo} of {h} rows, not {rows}")
    buf = x.new_zeros((b, c, 2 * n * k + 1, w))
    m = min(k, rows)
    if m:
        buf[:, :, 2 * r * k:2 * r * k + m] = x[:, :, :m]
        buf[:, :, (2 * r + 1) * k:(2 * r + 1) * k + m] = x[:, :, rows - m:]
    return buf


def _edge_index(row: int, h: int, n: int, k: int) -> int:
    """Where global ``row`` sits in the summed halo buffer."""
    if row < 0 or row >= h:
        return 2 * n * k
    for q in range(n):
        lo, hi = row_range(h, n, q)
        if lo <= row < hi:
            m = min(k, hi - lo)
            if row - lo < m:
                return 2 * q * k + row - lo
            if row >= hi - m:
                return (2 * q + 1) * k + row - (hi - m)
            break
    raise ValueError(f"row {row} is not within {k} rows of its owner's edge")


def halo_take(x: torch.Tensor, edges: torch.Tensor, h: int, n: int, r: int,
              k: int, lo: int, hi: int) -> torch.Tensor:
    """The global rows ``[lo, hi)`` of the level, zeros outside the image:
    rank ``r``'s own from ``x``, the rest from ``edges``, the summed
    ``halo_edges`` of every rank with the same ``k``."""
    own_lo, own_hi = row_range(h, n, r)
    parts = []
    top = list(range(lo, min(hi, own_lo)))
    if top:
        parts.append(_rows_of(edges, top, h, n, k))
    a, b = max(lo, own_lo), min(hi, own_hi)
    if a < b:
        parts.append(x[:, :, a - own_lo:b - own_lo])
    bottom = list(range(max(lo, own_hi), hi))
    if bottom:
        parts.append(_rows_of(edges, bottom, h, n, k))
    if not parts:
        return x[:, :, :0]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _rows_of(edges, rows, h, n, k):
    idx = torch.tensor([_edge_index(i, h, n, k) for i in rows],
                       device=edges.device)
    return edges.index_select(2, idx)


class SpaceAxis:
    """The space axis of a mesh at work: this rank's ``rank`` of ``size``,
    the ``group`` its collectives run over (None for one rank), and the
    ops of the forward on row bands. With ``train`` its sums join the
    graph on every rank and are kept for ``tie``."""

    def __init__(self, mesh: Mesh, train: bool = False):
        n_space = mesh.shape[1]
        self.size = n_space
        self.rank = mesh_coords(mesh)[1] if mesh.group is not None else 0
        self.group = mesh.groups.get("space") if n_space > 1 else None
        self.train = train
        self.exchanged = []

    def own(self, h: int) -> tuple:
        return row_range(h, self.size, self.rank)

    def all_sum(self, t: torch.Tensor, grad: bool = True) -> torch.Tensor:
        """``t`` summed over the group: in training and where ``grad``,
        through ``mesh.all_sum(force=True)``, else in place."""
        if self.group is None:
            return t
        if not (self.train and grad):
            dist.all_reduce(t, group=self.group)
            return t
        out = all_sum(t, self.group, force=True)
        self.exchanged.append(out)
        return out

    def tie(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` plus an exact zero that depends on every differentiable
        sum since the last tie, so that the backward reaches each of them
        on every rank, whatever the band's ops used."""
        zero = sum(e.reshape(-1)[:0].sum() for e in self.exchanged)
        self.exchanged = []
        return t + zero

    def take(self, x: torch.Tensor, h: int, request) -> torch.Tensor:
        """This rank's global rows ``[lo, hi) = request(self.rank)`` of a
        level of height ``h`` (zeros outside the image), through one
        exchange as wide as the widest reach of any rank q's request,
        ``request(q)``, beyond its band."""
        k = 0
        for q in range(self.size):
            lo, hi = request(q)
            own_lo, own_hi = row_range(h, self.size, q)
            k = max(k, own_lo - lo, hi - own_hi)
        edges = self.all_sum(halo_edges(x, h, self.size, self.rank, k))
        return halo_take(x, edges, h, self.size, self.rank, k,
                         *request(self.rank))

    def gather(self, x: torch.Tensor, h: int, grad: bool = True
               ) -> torch.Tensor:
        """The whole level (B,C,h,W) on every rank of the group."""
        lo, hi = self.own(h)
        out = x.new_zeros(x.shape[:2] + (h, x.shape[3]))
        out[:, :, lo:hi] = x
        return self.all_sum(out, grad)

    def heights(self, *bands) -> list:
        """The whole heights of NCHW ``bands`` (each this rank's rows of a
        level), from one sum of the row counts without gradient."""
        rows = torch.tensor([b.shape[2] for b in bands], dtype=torch.int64,
                            device=bands[0].device)
        return self.all_sum(rows, grad=False).tolist()

    # -- ops on row bands --

    def conv(self, conv, x: torch.Tensor, h: int) -> tuple:
        """``conv`` (no height padding of its own) on the band's rows of a
        level of height ``h``: (this rank's rows of the output, the output
        level's height)."""
        k, s = conv.kernel_size[0], conv.stride[0]
        p, d = conv.padding[0], conv.dilation[0]
        h_out = (h + 2 * p - d * (k - 1) - 1) // s + 1

        def request(q):
            lo, hi = row_range(h_out, self.size, q)
            return lo * s - p, (hi - 1) * s - p + d * (k - 1) + 1

        return conv_rows(conv, self.take(x, h, request)), h_out

    def deconv(self, deconv, x: torch.Tensor, h: int) -> tuple:
        """The transposed ``deconv`` on the band's rows: (this rank's rows
        of the output, the output level's height)."""
        k, s, p = deconv.kernel_size[0], deconv.stride[0], deconv.padding[0]
        h_out = (h - 1) * s - 2 * p + k

        def request(q):
            lo, hi = row_range(h_out, self.size, q)
            return -((k - 1 - p - lo) // s), (hi - 1 + p) // s + 1

        xin = self.take(x, h, request)
        lo, hi = self.own(h_out)
        if lo == hi:
            return x.new_zeros(x.shape[:1] + (deconv.out_channels, 0)
                               + (x.shape[3] * s,)), h_out
        out = F.conv_transpose2d(
            xin, deconv.weight, deconv.bias, deconv.stride,
            (0, deconv.padding[1]), deconv.output_padding, deconv.groups,
            deconv.dilation)
        first = request(self.rank)[0] * s - p  # global row of out[:, :, 0]
        return out[:, :, lo - first:hi - first], h_out

    def upsample(self, x: torch.Tensor, h: int, is_flow: bool) -> tuple:
        """``ops/resize.py:upsample`` (2x) on the band's rows."""
        h_out = 2 * h

        def request(q):
            lo, hi = row_range(h_out, self.size, q)
            return max((lo - 1) // 2, 0), min(hi // 2 + 1, h)

        xin = self.take(x, h, request)
        lo, hi = self.own(h_out)
        if lo == hi:
            return x.new_zeros(x.shape[:3] + (2 * x.shape[3],))[:, :, :0], h_out
        out = resize_bilinear(xin, (2 * xin.shape[2], 2 * xin.shape[3]))
        first = 2 * request(self.rank)[0]
        out = out[:, :, lo - first:hi - first]
        return (out * 2.0 if is_flow else out), h_out

    def normalize_features(self, f1: torch.Tensor, f2: torch.Tensor, h: int):
        """``ops/cost_volume.py:normalize_features`` with each image's sums
        over (C,H,W) taken over the group."""
        dims = (1, 2, 3)
        n = f1.shape[1] * h * f1.shape[3]
        m = self.all_sum(torch.stack([f1.sum(dim=dims), f2.sum(dim=dims)])) / n
        m1, m2 = m[0].view(-1, 1, 1, 1), m[1].view(-1, 1, 1, 1)
        v = self.all_sum(torch.stack([(f1 - m1).square().sum(dim=dims),
                                      (f2 - m2).square().sum(dim=dims)]))
        v = v / max(n - 1, 1)
        mean = (m1 + m2) / 2
        std = torch.sqrt((v[0] + v[1]).view(-1, 1, 1, 1) / 2 + 1e-16)
        return (f1 - mean) / std, (f2 - mean) / std

    def cost_volume(self, f1: torch.Tensor, f2: torch.Tensor, h: int,
                    md: int) -> torch.Tensor:
        """``compute_cost_volume`` of the band: the op on the band with
        ``md`` halo rows of both features, cropped to the band."""
        def request(q):
            lo, hi = row_range(h, self.size, q)
            return lo - md, hi + md

        f1h, f2h = self.take(f1, h, request), self.take(f2, h, request)
        rows = f1.shape[2]
        if rows == 0:
            return f1.new_zeros((f1.shape[0], (2 * md + 1) ** 2, 0, f1.shape[3]))
        return compute_cost_volume(f1h, f2h, md)[:, :, md:md + rows]


def conv_rows(conv, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on rows that already hold its halo (no height padding):
    the output rows they determine; none where ``x`` is the halo alone."""
    k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
    if x.shape[2] <= d * (k - 1):
        return x.new_zeros((x.shape[0], conv.out_channels, 0,
                            (x.shape[3] + 2 * conv.padding[1]
                             - d * (k - 1) - 1) // s + 1))
    return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                    (0, conv.padding[1]), conv.dilation, conv.groups)


def _refuse(model) -> None:
    from arflow_tpu_torch.models.layers import int8_pyramid_enabled
    from arflow_tpu_torch.models.uflow import PWCFlow

    if type(model) is not PWCFlow:
        raise NotImplementedError(
            f"the spatial forward takes the uflow model (PWCFlow), not "
            f"{type(model).__name__}; ROADMAP.md queue 1, 'parallel'")
    convs = [c for level in model._feature_pyramid_extractor._convs
             for c in level]
    if (model.compute_dtype is not None
            or any(c.int8 is not None and int8_pyramid_enabled(c.int8)
                   for c in convs)):
        raise NotImplementedError(SPATIAL_NOT_PORTED)


def _pyramid(model, ax: SpaceAxis, img: torch.Tensor, h: int):
    """This rank's rows of every pyramid level, and the levels' heights."""
    x = img * 2.0 - 1.0
    features, heights = [], []
    for level in model._feature_pyramid_extractor._convs:
        for conv in level:
            x, h = ax.conv(conv, x, h)
            x = F.leaky_relu(x, 0.1)
        features.append(x)
        heights.append(h)
    return features, heights


def _flows(model, ax: SpaceAxis, fp1, fp2, heights, generator=None) -> list:
    """``PWCFlow.forward_2_frames`` on the bands: NCHW flows, finest first,
    this rank's rows of each. With ``generator``, level dropout draws from
    it, one draw per level and one for the refinement, as the one-process
    model does (every rank of the mesh draws alike)."""
    from arflow_tpu_torch.models.uflow import (
        MAX_DISPLACEMENT,
        NUM_LEVELS,
        level_dropout,
    )

    flow = flow_up = context = context_up = up_h = None
    flows = []
    for level in range(NUM_LEVELS - 1, 0, -1):
        h = heights[level]
        if flow_up is not None and up_h != h:
            raise ValueError(f"level {level} has {h} rows, its upsampled flow "
                             f"{up_h}")
        context, flow = _estimate(model, ax, level, h, fp1[level], fp2[level],
                                  flow_up, context_up, MAX_DISPLACEMENT)
        context, flow = level_dropout([context, flow], model.level_dropout,
                                      generator)
        if flow_up is not None:
            flow = flow + flow_up
        flow_up, up_h = ax.upsample(flow, h, is_flow=True)
        context_up, _ = ax.deconv(model._context_up_layers[level], context, h)
        flows.insert(0, flow)

    h = heights[1]
    x = torch.cat([context, flow], dim=1)
    for layer in model._refine_model:
        x = ax.conv(layer, x, h)[0] if isinstance(layer, torch.nn.Conv2d) \
            else layer(x)
    (x,) = level_dropout([x], model.level_dropout, generator)
    flows[0] = flow + x
    for _ in range(2):
        up, h = ax.upsample(flows[0], h, is_flow=True)
        flows.insert(0, up)
    return flows


def _estimate(model, ax, level, h, features1, features2, flow_up, context_up,
              md):
    """``PWCFlow._estimate`` on the bands: the warp against the gathered
    level, the group's feature normalization, the cost volume with halos,
    and the dense-net decoder, whose every conv output is exchanged once
    so that its halo rides along into the next convs."""
    lo, hi = ax.own(h)
    if flow_up is None:
        warped2 = features2
    else:
        whole = ax.gather(features2, h)
        if lo == hi:
            warped2 = features2
        else:
            warped2 = resample(whole, flow_to_warp(flow_up, lo))

    f1n, w2n = features1, warped2
    if model.feature_norm:
        f1n, w2n = ax.normalize_features(features1, warped2, h)
    cost_volume = F.leaky_relu(ax.cost_volume(f1n, w2n, h, md), 0.1)

    if flow_up is None:
        x = torch.cat([cost_volume, features1], dim=1)
    else:
        x = torch.cat([context_up, flow_up, cost_volume, features1], dim=1)

    def ring(q):  # one row around the band: every decoder conv is 3x3
        a, b = row_range(h, ax.size, q)
        return a - 1, b + 1

    x = ax.take(x, h, ring)
    hidden = model._flow_layers[level][:-1]
    for i, (conv, act) in enumerate(hidden):
        context = act(conv_rows(conv, x))
        context_ring = ax.take(context, h, ring)
        if i + 1 < len(hidden):
            x = torch.cat([x, context_ring], dim=1)
    return context, conv_rows(model._flow_layers[level][-1], context_ring)


def spatial_forward(model, mesh: Mesh, img1: torch.Tensor, img2: torch.Tensor,
                    with_bk: bool = True, train: bool = False,
                    generator: torch.Generator | None = None) -> dict:
    """``PWCFlow.forward`` on this rank's part of the images
    (``shard_images_spatial``: NHWC, its batch part and rows):
    ``{'flows_fw'[, 'flows_bw']}``, each 6 NHWC flows, finest first, this
    rank's rows of each (``gather_flows`` assembles them). Every rank of
    the mesh calls it with its part.

    ``train=True`` keeps the graph for a backward (see the module's
    docstring) and turns level dropout on; it draws from ``generator``,
    which every rank seeds and advances alike, and which it then needs
    unless ``level_dropout`` is 0. bfloat16 and int8 raise."""
    _refuse(model)
    if train and model.level_dropout > 0:
        if generator is None:
            raise ValueError("spatial_forward(train=True) with level_dropout "
                             "> 0 needs a torch.Generator that every rank "
                             "seeds and advances alike")
    else:
        generator = None
    ax = SpaceAxis(mesh, train)
    x1, x2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    (height,) = ax.heights(x1)
    with torch.set_grad_enabled(train):
        fp1, heights = _pyramid(model, ax, x1, height)
        fp2, _ = _pyramid(model, ax, x2, height)
        res = {"flows_fw": _flows(model, ax, fp1, fp2, heights, generator)}
        if with_bk:
            res["flows_bw"] = _flows(model, ax, fp2, fp1, heights, generator)
        if train:
            res["flows_fw"][0] = ax.tie(res["flows_fw"][0])
    return {k: [f.permute(0, 2, 3, 1).contiguous() for f in v]
            for k, v in res.items()}


@torch.no_grad()
def gather_flows(mesh: Mesh, res: dict) -> dict:
    """The global flows of ``spatial_forward``'s result on every rank of
    the mesh: each NHWC flow's rows from the space group and its batch
    parts from the data groups, through one all-reduce of a zero-filled
    tensor (and one of the row counts)."""
    ax = SpaceAxis(mesh)
    keys = sorted(res)
    flows = [f for k in keys for f in res[k]]
    heights = ax.heights(*(f.permute(0, 3, 1, 2) for f in flows))
    d = mesh_coords(mesh)[0] if mesh.group is not None else 0
    out = []
    for f, h in zip(flows, heights):
        b = f.shape[0]
        whole = f.new_zeros((b * mesh.shape[0], h) + f.shape[2:])
        lo, hi = ax.own(h)
        whole[d * b:(d + 1) * b, lo:hi] = f
        if mesh.group is not None:
            dist.all_reduce(whole, group=mesh.group)
        out.append(whole)
    n = len(flows) // len(keys)
    return {k: out[i * n:(i + 1) * n] for i, k in enumerate(keys)}


# -- training: UFlowLoss on the bands, the value and the gradients -------------

CENSUS_PATCH = 7  # ops/census.py's default, which UFlowLoss takes


def resize_rows(whole: torch.Tensor, out_hw, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``resize_bilinear(whole, out_hw)`` for a
    resize by a whole factor along the height, from the input rows that
    ``_resize_matrix`` gives those rows taps in: upsampling by ``f``, the
    taps' rows ``[a, b)`` resized by ``f`` are global rows ``[f a, f b)``
    (clamped at the image's edges as the whole's are); downsampling by
    ``f``, the aligned rows ``[f lo, f hi)``, which hold the taps. Equal
    to the whole's rows bit for bit."""
    h, oh = whole.shape[2], int(out_hw[0])
    if lo >= hi:
        return whole.new_zeros(whole.shape[:2] + (0, int(out_hw[1])))
    taps = np.nonzero(_resize_matrix(h, oh)[lo:hi].any(axis=0))[0]
    a, b = int(taps[0]), int(taps[-1]) + 1
    if oh >= h and oh % h == 0:
        f = oh // h
        first, window, size = f * a, whole[:, :, a:b], f * (b - a)
    elif oh < h and h % oh == 0:
        f = h // oh
        first, window, size = lo, whole[:, :, f * lo:f * hi], hi - lo
        a, b = f * lo, f * hi
    else:
        raise ValueError(f"a resize of {h} rows to {oh} is not by a whole "
                         "factor")
    if not (first <= lo and hi <= first + size and a <= taps[0]
            and taps[-1] < b):
        raise ValueError(f"rows [{lo}, {hi}) of {oh} read rows outside "
                         f"[{a}, {b}) of {h}")
    out = resize_bilinear(window, (size, int(out_hw[1])))
    return out[:, :, lo - first:hi - first]


def _occlusion_rows(ax: SpaceAxis, flow_2: torch.Tensor, h2: int, h: int
                    ) -> torch.Tensor:
    """``UFlowLoss._occlusion`` of this rank's rows of the level-2 flow:
    its range map splatted into the whole level in global rows, summed over
    the group without gradient (``occlusion.py``'s guards hold: no NaN
    index), clipped, and the band's rows of its 4x upsample."""
    from arflow_tpu_torch.ops import compute_range_map

    if h != int(h2 * 4.0):
        raise ValueError(f"the level-2 flow has {h2} rows, the image {h}")
    counts = compute_range_map(flow_2.detach(), ax.own(h2)[0], h2)
    occu = ax.all_sum(counts, grad=False).clamp(0.0, 1.0)
    return resize_rows(occu, (h, int(occu.shape[3] * 4.0)), *ax.own(h))


def _census_rows(ax: SpaceAxis, targets: torch.Tensor, recons: torch.Tensor,
                 mask: torch.Tensor, h: int, mesh_sum, num_groups: int
                 ) -> torch.Tensor:
    """``census_loss(..., num_groups)`` of this rank's rows: the 7x7
    patches read ``CENSUS_PATCH // 2`` halo rows of the whole targets and
    of the reconstructions (zeros outside the image), the border that
    ``zero_mask_border`` zeroes is the image's, and the sums run over the
    mesh."""
    from arflow_tpu_torch.ops.census import (
        abs_robust_loss,
        census_transform,
        soft_hamming,
    )

    pad = CENSUS_PATCH // 2
    lo, hi = ax.own(h)
    w = targets.shape[3]

    def ring(q):
        a, b = row_range(h, ax.size, q)
        return a - pad, b + pad

    a, b = lo - pad, hi + pad
    t_ext = F.pad(targets[:, :, max(a, 0):min(b, h)],
                  (0, 0, max(-a, 0), max(b - h, 0)))
    r_ext = ax.take(recons, h, ring)
    hamming = soft_hamming(
        census_transform(t_ext, CENSUS_PATCH)[:, :, pad:pad + hi - lo],
        census_transform(r_ext, CENSUS_PATCH)[:, :, pad:pad + hi - lo])
    rows = torch.arange(lo, hi, device=mask.device)
    cols = torch.arange(w, device=mask.device)
    border = (((rows >= pad) & (rows < h - pad)).view(-1, 1)
              & ((cols >= pad) & (cols < w - pad)).view(1, -1))
    padded_mask = mask * border.to(mask.dtype)
    diff = abs_robust_loss(hamming) * padded_mask
    dims = (1, 2, 3, 4)
    return (mesh_sum(diff.unflatten(0, (num_groups, -1)).sum(dim=dims), True)
            / (mesh_sum(padded_mask.detach().unflatten(0, (num_groups, -1))
                        .sum(dim=dims)) + 1e-6))


def _smooth_rows(ax: SpaceAxis, cfg, images: torch.Tensor, flow_2: torch.Tensor,
                 h2: int, mesh_mean) -> torch.Tensor:
    """``UFlowLoss._smooth_one_direction`` of this rank's rows of the
    level-2 flow: ``downsample(images, 4)`` from the whole images' rows
    its taps read (``resize_rows``), the forward differences along H with
    the rows below the band (none past the image's last row, the flow's
    through an exchange), and each mean over the mesh divided by the
    whole's count."""
    from arflow_tpu_torch.ops.census import robust_l1

    if cfg.smooth_order not in (1, 2):
        raise NotImplementedError(f"smooth_order {cfg.smooth_order}")
    # the image differences' stride, and the rows below the band that the
    # flow's differences (second ones for order 2) read
    stride = cfg.smooth_order
    lo, hi = ax.own(h2)
    rows = hi - lo
    im = resize_rows(images.detach(), (h2, int(images.shape[3] / 4.0)), lo,
                     min(hi + stride, h2))
    im_gx = im[:, :, :rows, stride:] - im[:, :, :rows, :-stride]
    im_gy = im[:, :, stride:] - im[:, :, :-stride]
    ec = cfg.edge_constant
    weights_x = torch.exp(-(ec * im_gx).abs().mean(dim=1, keepdim=True))
    weights_y = torch.exp(-(ec * im_gy).abs().mean(dim=1, keepdim=True))

    def below(q):
        a, b = row_range(h2, ax.size, q)
        return a, min(b + stride, h2)

    fl = ax.take(flow_2, h2, below)
    flow_gx = fl[:, :, :rows, 1:] - fl[:, :, :rows, :-1]
    flow_gy = fl[:, :, 1:] - fl[:, :, :-1]
    if cfg.smooth_order == 1:
        tx, ty = flow_gx, flow_gy
    else:
        tx = flow_gx[:, :, :, 1:] - flow_gx[:, :, :, :-1]
        ty = flow_gy[:, :, 1:] - flow_gy[:, :, :-1]
    return cfg.w_smooth * (
        mesh_mean(weights_x * robust_l1(tx.square()), h2)
        + mesh_mean(weights_y * robust_l1(ty.square()), h2 - stride)) / 2.0


def spatial_uflow_loss(loss, mesh: Mesh, res: dict, img1: torch.Tensor,
                       img2: torch.Tensor) -> dict:
    """``UFlowLoss`` (``loss``, its ``cfg``) of the global flows and
    images from this rank's rows of them: ``res`` as ``spatial_forward``
    returns it, the images as ``shard_images_spatial`` hands them out.
    Every rank of the mesh calls it and gets the whole loss's ``total``,
    ``l_ph``, ``l_sm`` and ``flow_mean``, and its own rows of ``mask1``
    (NHWC), as GSPMD partitions the loss under the JAX mesh.

    Warp coordinates carry the band's global rows and test against the
    whole image; the reconstructions sample the whole images, gathered once
    without gradient; the occlusion splats into the whole level-2 map, which
    the group sums; census and smoothness read their halo rows through the
    exchange; every sum runs over the mesh and every mean divides by the
    whole's count, which the row ranges give."""
    cfg = loss.cfg
    ax = SpaceAxis(mesh, train=True)
    n_data = mesh.shape[0]

    def mesh_sum(t, force=False):
        return all_sum(t, mesh.group, force)

    def mesh_mean(t, rows):  # t: NCHW, this rank's rows of ``rows``
        count = t.shape[0] * n_data * t.shape[1] * rows * t.shape[3]
        return mesh_sum(t.sum(), True) / count

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous()

    flows_fw, flows_bw = res["flows_fw"], res["flows_bw"]
    flow12_0 = nchw(flows_fw[0][..., 0:2])
    flow12_2 = nchw(flows_fw[2][..., 0:2])
    flow21_2 = nchw(flows_bw[2][..., 0:2])
    img1, img2 = nchw(img1), nchw(img2)
    h, h2 = ax.heights(img1, flow12_2)
    lo = ax.own(h)[0]
    whole = ax.gather(torch.cat([img1, img2], dim=1).detach(), h, grad=False)
    whole1, whole2 = whole[:, :3], whole[:, 3:]

    if cfg.with_bk:
        flow21_0 = nchw(flows_bw[0][..., 0:2])
        targets = torch.cat([whole1, whole2], dim=0)
        warp12_0 = flow_to_warp(flow12_0, lo)
        warp21_0 = flow_to_warp(flow21_0, lo)
        recons = torch.cat([resample(whole2, warp12_0),
                            resample(whole1, warp21_0)], dim=0)
        valid = mask_invalid(torch.cat([warp12_0, warp21_0], dim=0), h)
        occu = _occlusion_rows(ax, torch.cat([flow21_2, flow12_2], dim=0), h2, h)
        mask = (occu * valid).detach()
        loss_warp = cfg.w_census * _census_rows(
            ax, targets, recons, mask, h, mesh_sum, 2).sum()
        loss_smooth = 2.0 * _smooth_rows(
            ax, cfg, targets, torch.cat([flow12_2, flow21_2], dim=0), h2,
            mesh_mean)
        mask1 = mask[:img1.shape[0]]
    else:
        warp12_0 = flow_to_warp(flow12_0, lo)
        im1_recons = resample(whole2, warp12_0)
        mask1 = (_occlusion_rows(ax, flow21_2, h2, h)
                 * mask_invalid(warp12_0, h)).detach()
        loss_warp = cfg.w_census * _census_rows(
            ax, whole1, im1_recons, mask1, h, mesh_sum, 1).sum()
        loss_smooth = _smooth_rows(ax, cfg, whole1, flow12_2, h2, mesh_mean)

    flows = torch.cat([flows_fw[0], flows_bw[0]], dim=-1).abs()
    flow_mean = mesh_sum(flows.sum().detach()) / (
        flows.shape[0] * n_data * h * flows.shape[2] * flows.shape[3])
    total = ax.tie(loss_warp + loss_smooth)
    return {"total": total, "l_ph": loss_warp, "l_sm": loss_smooth,
            "flow_mean": flow_mean, "mask1": mask1.permute(0, 2, 3, 1).contiguous()}


def spatial_value_and_grad(model, loss, mesh: Mesh, img1: torch.Tensor,
                           img2: torch.Tensor,
                           generator: torch.Generator | None = None) -> dict:
    """The uflow objective on the mesh, the counterpart of the JAX
    package's ``value_and_grad`` under ``spatial_apply``: ``spatial_forward``
    in training mode (level dropout from ``generator``, which every rank
    seeds and advances alike), ``spatial_uflow_loss`` (``loss``: a
    ``UFlowLoss``), its backward and ``average_grads``. Every rank of the
    mesh calls it with its part of the images; it returns the loss's
    values (detached, ``mask1`` this rank's rows) and replaces every
    parameter's ``.grad`` with the one-process gradient."""
    for p in model.parameters():
        p.grad = None
    res = spatial_forward(model, mesh, img1, img2, train=True,
                          generator=generator)
    out = spatial_uflow_loss(loss, mesh, res, img1, img2)
    out["total"].backward()
    average_grads(model.parameters(), mesh.group)
    return {k: v.detach() for k, v in out.items()}
