"""Shared set-up of the tests that hold the port's ``MixtureWeightsNet``
and its BatchNorm ResNet to ``arflow_tpu``'s: JAX variables with
``batch_stats`` from a seed, and the comparison of running statistics."""

import numpy as np

import jax
import jax.numpy as jnp

from torch_port_util import H, W, init_shapes

# chairs_uflow_elbo_mixture.json's model, dropout off.
MIXTURE = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.0,
           "out_channels": [2, 2, 0], "inv_cov": False, "mixture_weights": True,
           "n_pyramids": 2}
COMPONENT_MIXTURE = {"type": "component", "out_channels": [2, 2, 0],
                     "mixture_weights": True}


def draw_variables(module, args, seed, **init_kwargs):
    """``{'params', 'batch_stats'}`` of ``module.init(rng, *args)`` as numpy
    float32 from ``RandomState(seed)`` (shapes from ``init_shapes``):
    xavier-uniform kernels, biases in +-0.1, BatchNorm scales in [0.5,
    1.5], running means in +-0.5 and variances in [0.5, 2]."""
    shapes = init_shapes(module, *args, **init_kwargs)
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            out = rs.uniform(0.5, 1.5, shape)
        elif name == "mean":
            out = rs.uniform(-0.5, 0.5, shape)
        elif name == "var":
            out = rs.uniform(0.5, 2.0, shape)
        elif len(shape) == 1:
            out = rs.uniform(-0.1, 0.1, shape)
        else:
            receptive = int(np.prod(shape[:-2]))
            limit = np.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
            out = rs.uniform(-limit, limit, shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def as_f64(tree):
    return jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), tree)


def image_pair(b, seed, h=H, w=W):
    """Blocky textures with noise, the second moved by (1, 2) pixels, in
    [0, 1], float64 NHWC."""
    rs = np.random.RandomState(seed)
    base = rs.rand(b, h // 8 + 2, w // 8 + 2, 3)
    tex = np.kron(base, np.ones((1, 8, 8, 1)))[:, :h + 8, :w + 8]
    tex = np.clip(tex + 0.05 * rs.randn(*tex.shape), 0, 1)
    return tex[:, 4:4 + h, 4:4 + w], tex[:, 3:3 + h, 2:2 + w]


def bn_stats_of(model) -> dict:
    """(running_mean, running_var) of each ``FlaxBatchNorm2d`` by its
    module name."""
    from arflow_tpu_torch.models.uflow_prob import FlaxBatchNorm2d

    return {name: (m.running_mean, m.running_var)
            for name, m in model.named_modules() if isinstance(m, FlaxBatchNorm2d)}


def jax_bn_stats(stats, prefix) -> dict:
    """The ``resnet`` scope's ``batch_stats`` -> {port module name: (mean,
    var)}, float64 numpy."""
    pre = f"{prefix}." if prefix else ""
    out = {f"{pre}conv1.1": stats["bn1"]}
    names = {"bn1": "conv1.1", "bn2": "conv2.1", "downsample_bn": "downsample.1"}
    for scope, block in stats.items():
        if scope.startswith("layer"):
            stage, blk = scope[len("layer"):].split("_block")
            for bn, s in block.items():
                out[f"{pre}layer{stage}.{blk}.{names[bn]}"] = s
    return {k: (np.asarray(v["mean"], np.float64), np.asarray(v["var"], np.float64))
            for k, v in out.items()}


def stats_gap(port_model, jax_stats, prefix) -> float:
    """Largest |port - JAX| over every BatchNorm's running mean and
    variance, relative to that statistic's largest magnitude; the port's
    and JAX's BatchNorm layers must be the same 20."""
    ours = bn_stats_of(port_model)
    want = jax_bn_stats(jax_stats, prefix)
    assert sorted(ours) == sorted(want) and len(want) == 20
    gap = 0.0
    for name, pair in want.items():
        for t, w in zip(ours[name], pair):
            gap = max(gap, float(np.abs(t.detach().double().numpy() - w).max()
                                 / np.abs(w).max()))
    return gap
