"""Port vs reference: the RWKV6 (ssm) family, from the block to serving.

The reference's `init_params` for the rwkv6-3b smoke config (2 layers,
d 128, 8 WKV heads of 16, vocab 512) in float32 is bridged into the port
(numpy leaves), so both sides compute with the same weights:

* `time_mix` (multi-token and the one-step s == 1 branch), `channel_mix`
  and the ssm `_layer_full` at atol 2e-5; `forward_exits` conf at the
  model test's CONF_ATOL, preds exactly equal;
* parameter names are the reference's paths, including the channel-mix
  leaves the reference keeps unused under ``tm``; `param_count` equals
  the reference's at full width;
* SplitEE serving through the port on the CPU and the reference's
  `EdgeCloudRuntime` (WKV oracle, exit heads in Pallas interpret mode)
  takes the same decisions: arms, exits, preds and offload bytes equal,
  cost and rewards within 1e-6, with alpha in a gap of the confidences
  as in test_torch_serving.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.core import CostModel as JCostModel
from repro.data import OnlineStream, make_dataset
from repro.models import rwkv6 as jrk
from repro.models import transformer as jtf
from repro.serving.batched import _serve_stream_batched as j_batched
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro.serving.simulator import _serve_stream_sequential as j_sequential
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import rwkv6 as trk
from repro_torch.models import transformer as ttf
from repro_torch.serving import (EdgeCloudRuntime, _serve_stream_batched,
                                 _serve_stream_sequential)

ARCH = "rwkv6-3b"
ATOL = 2e-5
CONF_ATOL = 1e-5
N_SAMPLES = 37          # not a multiple of the batch size 8
ALPHA_MARGIN = 1e-4


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(t_get_smoke_config(ARCH), dtype=dtype))


@pytest.fixture(scope="module")
def bridged():
    cfg, tcfg = _cfgs()
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _heads(cfg):
    return cfg.ssm.num_heads or cfg.d_model // cfg.ssm.state_size


def _layer(jp, tp, i):
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            ttf.layer_params(tp["layers"], i))


def _close(want, got, atol=ATOL):
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                               atol=atol)


# ------------------------------------------------------------------ the block

@pytest.mark.parametrize("s", [16, 1])
def test_time_mix_matches_reference(bridged, s):
    cfg, _, jp, tp = bridged
    jl, tl = _layer(jp, tp, 1)
    heads, d = _heads(cfg), cfg.d_model
    rng = np.random.default_rng(s)
    x = rng.standard_normal((3, s, d)).astype(np.float32)
    last = rng.standard_normal((3, d)).astype(np.float32)
    state = (rng.standard_normal((3, heads, d // heads, d // heads)) * 0.3
             ).astype(np.float32)
    ref, (rl, rs) = jrk.time_mix(jl["tm"], jnp.asarray(x),
                                 (jnp.asarray(last), jnp.asarray(state)),
                                 num_heads=heads, backend="pallas_interpret",
                                 chunk=cfg.ssm.chunk_size)
    reset_launch_counts()
    got, (gl, gs) = trk.time_mix(tl["tm"], torch.from_numpy(x),
                                 (torch.from_numpy(last),
                                  torch.from_numpy(state)),
                                 num_heads=heads, chunk=cfg.ssm.chunk_size)
    assert launch_counts()["wkv6"] == 0
    _close(ref, got)
    _close(rl, gl)
    _close(rs, gs)


def test_channel_mix_matches_reference(bridged):
    cfg, _, jp, tp = bridged
    jl, tl = _layer(jp, tp, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    ref, rl = jrk.channel_mix(jl["cm"], jnp.asarray(x), jnp.asarray(last))
    got, gl = trk.channel_mix(tl["cm"], torch.from_numpy(x),
                              torch.from_numpy(last))
    _close(ref, got)
    _close(rl, gl)


def test_layer_full_matches_reference(bridged):
    cfg, tcfg, jp, tp = bridged
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jl, tl = _layer(jp, tp, 1)
    ref, _ = jtf._layer_full(cfg, jp, jl, jnp.asarray(x), jnp.asarray(pos), 1,
                             window=0, backend="pallas_interpret")
    got, _ = ttf._layer_full(tcfg, tp, tl, torch.from_numpy(x),
                             torch.from_numpy(pos), 1, window=0)
    _close(ref, got)


def test_forward_exits_matches_reference(bridged):
    cfg, tcfg, jp, tp = bridged
    toks = make_dataset("imdb_like", 12, seed=1)["tokens"]
    ref = jtf.forward_exits(jp, cfg, {"tokens": jnp.asarray(toks)},
                            backend="pallas_interpret",
                            conf_backend="pallas_interpret")
    got = ttf.forward_exits(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got["conf"].shape == (cfg.num_layers, 12)
    _close(ref["conf"], got["conf"], CONF_ATOL)
    np.testing.assert_array_equal(np.asarray(ref["pred"]),
                                  got["pred"].numpy())
    _close(ref["hidden"], got["hidden"], 1e-4)


# --------------------------------------------------------------- parameters

def test_param_names_are_reference_paths(bridged):
    cfg, _, jp, tp = bridged
    want = _paths(jax.tree.map(np.asarray, jp))
    got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    assert got == want
    # the reference keeps the channel-mix leaves under "tm" too, unused
    for leaf in ("mu_cm", "cm_wr", "cm_wk", "cm_wv", "bonus", "decay_a"):
        assert f"layers.tm.{leaf}" in got
    assert got["layers.tm.bonus"] == (cfg.num_layers, _heads(cfg),
                                      cfg.ssm.state_size)
    assert got["exit_w"] == (cfg.d_model, cfg.vocab_size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_layout(dtype):
    cfg, tcfg = _cfgs(dtype)
    want = _paths(jtf.abstract_params(cfg))
    tp = ttf.init_params(tcfg, seed=3, device="cpu")
    assert {n: tuple(p.shape) for n, p in tp.named_parameters()} == want
    assert all(p.dtype == getattr(torch, dtype) for p in tp.parameters())


def test_param_count_matches_reference():
    assert t_get_config(ARCH).param_count() == get_config(ARCH).param_count()
    _, tcfg = _cfgs()
    assert tcfg.param_count() == get_smoke_config(ARCH).param_count()


def test_bridge_bfloat16_round_trip():
    """A bf16 reference tree arrives bit for bit, with its paths."""
    cfg, _ = _cfgs("bfloat16")
    jp = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, device="cpu")
    flat = dict(tp.named_parameters())
    assert flat.keys() == _paths(jp).keys()
    for name, p in flat.items():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.float().numpy(),
                                      leaf.astype(np.float32))


# ------------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def served(bridged):
    cfg, tcfg, jp, tp = bridged
    data = make_dataset("imdb_like", N_SAMPLES, seed=1)
    conf = np.sort(np.asarray(jtf.forward_exits(
        jp, cfg, {"tokens": jnp.asarray(data["tokens"])})["conf"]).ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    alpha = float(conf[k] + conf[k + 1]) / 2
    assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
    return cfg, tcfg, jp, tp, alpha


PATHS = [
    # batch size (0 = sequential driver), side_info, fused_exit
    (0, False, False), (0, True, False), (0, False, True),
    (1, False, False), (8, False, False), (8, True, False),
    (8, False, True), (8, True, True),
]


@pytest.mark.parametrize("batch_size,side_info,fused_exit", PATHS)
def test_serving_matches_reference(served, batch_size, side_info, fused_exit):
    cfg, tcfg, jp, tp, alpha = served
    jrt = JRuntime(cfg, backend="ref", conf_backend="pallas_interpret",
                   fused_exit=fused_exit)
    trt = EdgeCloudRuntime(tcfg, device="cpu", fused_exit=fused_exit)
    jcost = JCostModel(num_layers=cfg.num_layers, alpha=alpha, offload=3.0)
    tcost = CostModel(num_layers=tcfg.num_layers, alpha=alpha, offload=3.0)
    jstream = OnlineStream(make_dataset("imdb_like", N_SAMPLES, seed=1), seed=0)
    tstream = TStream(t_make_dataset("imdb_like", N_SAMPLES, seed=1), seed=0)
    if batch_size == 0:
        ref = j_sequential(jrt, jp, jstream, jcost, side_info=side_info)
        got = _serve_stream_sequential(trt, tp, tstream, tcost,
                                       side_info=side_info)
    else:
        ref = j_batched(jrt, jp, jstream, jcost, side_info=side_info,
                        batch_size=batch_size)
        got = _serve_stream_batched(trt, tp, tstream, tcost,
                                    side_info=side_info,
                                    batch_size=batch_size)
    assert got["n"] == ref["n"] == N_SAMPLES
    for key in ("arms", "exited", "preds"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got["offload_bytes"] == ref["offload_bytes"]
    assert got["accuracy"] == ref["accuracy"]
    assert abs(got["cost_total"] - ref["cost_total"]) <= 1e-6
    np.testing.assert_allclose(got["rewards"], ref["rewards"], rtol=0,
                               atol=1e-6)
    assert 0 < ref["exited"].sum() < N_SAMPLES
