"""Shared set-up of the tests that hold the port's ``torch.export``
artifacts (``arflow_tpu_torch/serving/export.py``) to the eager port model
and to the JAX package's ``jax.export`` artifacts: a config with weights
from a seed in both packages' forms, frames from a seed, artifacts of both
packages and the eager outputs they are held to."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.serving import export as jax_export
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model, state_dict_from_jax
from arflow_tpu_torch.serving import StreamingFlowEngine, export
from arflow_tpu_torch.training.entropy import extract_uv_entropy
from arflow_tpu_torch.utils.gmm import mixture_hash_draws
from torch_port_util import H, W, draw_jax_params

# Each setup: the model and loss sections of a shipped config at the tests'
# width. uflow: configs/chairs_uflow.json; diag: sintel_uflow_elbo*.json;
# mixture: chairs_uflow_elbo_mixture.json without its weights net.
SETUPS = {
    "uflow": ({"type": "uflow", "feature_norm": True, "level_dropout": 0.0},
              {}),
    "diag": ({"type": "uflow_prob", "feature_norm": True,
              "level_dropout": 0.0, "out_channels": [2, 2, 0]},
             {"approx": "diag"}),
    "mixture": ({"type": "uflow_prob", "feature_norm": True,
                 "level_dropout": 0.0, "out_channels": [2, 2, 0],
                 "n_pyramids": 2},
                {"approx": "mixture", "n_components": 2}),
}
# float32 port against float32 JAX (relayouts on there): the bounds of
# tests/test_torch_serving.py, for flows and entropies alike (measured:
# flows at most 1.9e-5 on values up to 18.8, entropies 1.7e-6 (diag) and
# 5.2e-6 (mixture, JAX's draws) on values up to 3.6 and 7.6).
JAX_ATOL = 1e-4


def setup(name, seed=0):
    """(port Config, JAX Config, the port's state_dict, JAX variables)."""
    model_cfg, loss_cfg = SETUPS[name]
    full = {"model": model_cfg, "loss": loss_cfg}
    params = draw_jax_params(model_cfg, seed=seed, with_bk=False)
    cfg = Config(full)
    return cfg, JaxConfig(full), state_dict_from_jax(params, cfg.model), {
        "params": params}


def frames(n, seed, b=1):
    rs = np.random.RandomState(seed)
    return [rs.rand(b, H, W, 3).astype(np.float32) for _ in range(n)]


def artifact_draws(cfg, batch=1):
    """The Monte-Carlo draws of an artifact's ``mixture`` entropy: the
    eager ``mixture_hash_draws`` of ``export.DRAW_SEED`` (None for the
    other approximations, which draw nothing)."""
    if cfg.loss.get("approx") != "mixture":
        return None
    return mixture_hash_draws(cfg.loss.n_components, batch, (H, W),
                              seed=export.DRAW_SEED)


def eager(cfg, sd, img1, img2):
    """The eager port model's (flow, entropy), the entropy with the
    artifact's draws injected (``artifact_draws``)."""
    model = get_model(cfg.model, device="cpu")
    model.load_state_dict(sd, strict=True)
    a, b = torch.from_numpy(img1), torch.from_numpy(img2)
    with torch.no_grad():
        res = model(a, b, with_bk=False)
        flow = res["flows_fw"][0][..., :2]
        ent = (extract_uv_entropy(res["flows_fw"], cfg.loss, res,
                                  draws=artifact_draws(cfg, a.shape[0]))
               if "approx" in cfg.loss else torch.zeros_like(flow))
    return flow, ent, res


def port_artifact(cfg, sd, path, streaming=False, batch=1):
    """``path``, the port's monolithic or streaming artifact for the CPU."""
    if streaming:
        eps, meta = export.export_streaming(cfg, sd, batch, (H, W), device="cpu")
        export.save_streaming_artifact(str(path), eps, meta)
    else:
        ep, meta = export.export_inference(cfg, sd, batch, (H, W), device="cpu")
        export.save_artifact(str(path), ep, meta)
    return str(path)


def jax_artifact(jcfg, variables, path, streaming=False, batch=1):
    """``path``, the JAX package's artifact exported for the CPU."""
    if streaming:
        ex, meta = jax_export.export_streaming(jcfg, variables, batch, (H, W),
                                               platforms=("cpu",))
        jax_export.save_streaming_artifact(str(path), ex, meta)
    else:
        ex, meta = jax_export.export_inference(jcfg, variables, batch, (H, W),
                                               platforms=("cpu",))
        jax_export.save_artifact(str(path), ex, meta)
    return str(path)


def artifacts(name, root, streaming):
    """(cfg, state_dict, the port's artifact, the JAX artifact) of the
    setup ``name``, both of one kind, under ``root``."""
    cfg, jcfg, sd, variables = setup(name)
    kind = "stream" if streaming else "mono"
    return (cfg, sd,
            port_artifact(cfg, sd, root / f"port_{kind}.afx", streaming),
            jax_artifact(jcfg, variables, root / f"jax_{kind}.afx", streaming))


def engine(cfg, sd):
    return StreamingFlowEngine(cfg.model, sd, with_bw=True, device="cpu",
                               loss_cfg=cfg.loss)


def jax_mixture_draws(k, shape, n_samples=100):
    """The draws the JAX artifact's ``mixture_entropy`` makes from
    ``PRNGKey(0)`` for float32 maps of ``shape`` (B, H, W), uniform
    weights, in the port's ``draws=`` form (one key per sample, split into
    the component's and the normals' keys)."""
    weights = jnp.ones((shape[0], k), jnp.float32) / k

    def one(key):
        kz, ke = jax.random.split(key)
        return (jax.random.categorical(kz, jnp.log(weights), shape=(shape[0],)),
                jax.random.normal(ke, (*shape, 2), jnp.float32))

    z, eps = jax.jit(jax.vmap(one))(jax.random.split(jax.random.PRNGKey(0),
                                                     n_samples))
    return {"z": torch.from_numpy(np.array(z)).long(),
            "eps": torch.from_numpy(np.array(eps))}


def check_monolithic(cfg, sd, mono, jax_mono, jax_ent=None):
    """The loaded monolithic artifact against the eager port model (bit for
    bit) and the JAX artifact within ``JAX_ATOL``; where ``jax_ent`` is
    given, the JAX artifact's entropy is held to ``jax_ent(res)`` of the
    eager model's outputs instead of the artifact's."""
    art = export.load_artifact(mono)
    assert art.meta["format"] == 1 and art.meta["device"] == "cpu"
    assert art.meta["has_entropy"] == ("approx" in cfg.loss)
    assert art.meta["torch_version"] == torch.__version__
    img1, img2 = frames(2, seed=1)
    flow, ent = art(img1, img2)
    flow0, ent0, res = eager(cfg, sd, img1, img2)
    torch.testing.assert_close(flow, flow0, rtol=0, atol=0)
    torch.testing.assert_close(ent, ent0, rtol=0, atol=0)
    jflow, jent = jax_export.load_artifact(jax_mono)(img1, img2)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), rtol=0,
                               atol=JAX_ATOL)
    got = ent if jax_ent is None else jax_ent(res)
    np.testing.assert_allclose(got.numpy(), np.asarray(jent), rtol=0,
                               atol=JAX_ATOL)


def engine_entropy(eng, fp_prev, cfg):
    """The entropy of the engine's pair (``fp_prev``, its cached pyramids)
    with the artifact's draws injected (``artifact_draws``)."""
    with torch.no_grad():
        flows = eng._flows(fp_prev, eng._prev)
        return extract_uv_entropy(flows, cfg.loss, {"flows_fw": flows},
                                  draws=artifact_draws(cfg))


def check_streaming(cfg, sd, stream, jax_stream, jax_entropy=True):
    """The loaded streaming artifact, ``with_bw``, over 4 frames twice (a
    reset between) against the eager engine (bit for bit; its entropy with
    the artifact's draws injected) and the JAX streaming artifact
    (``JAX_ATOL``; the entropy too with ``jax_entropy``)."""
    art = export.load_streaming_artifact(stream)
    art.with_bw = True
    jart = jax_export.load_streaming_artifact(jax_stream)
    jart.with_bw = True
    eng = engine(cfg, sd)
    seq = frames(4, seed=2)
    for _ in range(2):
        art.reset(), jart.reset(), eng.reset()
        assert art.push(seq[0]) is None and eng.push(seq[0]) is None
        assert jart.push(seq[0]) is None
        for cur in seq[1:]:
            fp_prev = eng._prev
            out, want, jout = art.push(cur), eng.push(cur), jart.push(cur)
            assert sorted(out) == sorted(want) == sorted(jout)
            assert ("entropy" in out) == ("approx" in cfg.loss)
            if cfg.loss.get("approx") == "mixture":
                want["entropy"] = engine_entropy(eng, fp_prev, cfg)
            for key in want:
                assert tuple(out[key].shape) == (1, H, W, 2)
                torch.testing.assert_close(out[key], want[key], rtol=0, atol=0)
                if key != "entropy" or jax_entropy:
                    np.testing.assert_allclose(out[key].numpy(),
                                               np.asarray(jout[key]), rtol=0,
                                               atol=JAX_ATOL, err_msg=key)
