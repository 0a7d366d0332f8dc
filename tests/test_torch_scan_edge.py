"""Port vs reference: the masked scan edge phase.

* `forward_exits_masked` of the port against the reference's, dense
  (ElasticBERT smoke) and ssm (rwkv6-3b smoke), plain and fused exits,
  over a depth vector that holds every arm: conf at atol 1e-6, preds
  exactly equal, hidden at rtol = atol = 1e-4;
* `serve()` with ``edge_mode`` "scan" and "auto", port against the
  reference, B in {1, 8, 32}, both SplitEE variants (ElasticBERT; three
  of the cases for rwkv6), 37 samples (a ragged tail): arms, exits, preds and offload bytes exactly equal, rewards
  within 1e-6 (alpha in a gap of the stream's confidences, as in
  test_torch_serving.py);
* the port's scan phase against its bucketed phase on one forced batch
  mixing >= 3 depths: confidence paths within 2 ulp (the exit head runs at
  another row count), preds, queue depths/slots/hidden rows and the
  flushed cloud results bitwise;
* the reference's two mask properties: layers past the deepest depth
  (poisoned with NaN) and the content of padded rows never change a live
  output;
* `select_edge_phase` and the per-batch pick of "auto".
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # vendored fallback
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.data import OnlineStream, make_dataset
from repro.models import transformer as jtf
from repro.serving.api import ServingConfig as JConfig
from repro.serving.api import serve as jserve
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import ParamTree
from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve
from repro_torch.serving.batched import OffloadQueue, _edge_phase
from repro_torch.serving.scan_edge import (EDGE_MODES, _edge_phase_auto,
                                           _edge_phase_scan,
                                           select_edge_phase)

ARCHS = ["elasticbert12", "rwkv6-3b"]
N_SAMPLES = 37          # not a multiple of 8 or 32: a ragged tail
ALPHA_MARGIN = 1e-4
CONF_ATOL = 1e-6
# hidden after every layer, in float32: the frameworks sum in other
# orders, and the rwkv6 residual stream grows over the layers
HIDDEN_TOL = 1e-4
# the exit head at (L*B, D) and at (B, D) rows may differ in the last
# float32 bit: <= 2 ulp, as the reference's own scan suite pins
ULP_RTOL, ULP_ATOL = 1e-6, 1e-7


def _bridged(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(arch), dtype="float32")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return _bridged(request.param)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_exits_masked_matches_reference(bridged, fused):
    cfg, tcfg, jp, tp = bridged
    data = make_dataset("imdb_like", 6, seed=1)
    depths = np.arange(6) % cfg.num_layers
    ref = jtf.forward_exits_masked(
        jp, cfg, {"tokens": jnp.asarray(data["tokens"])},
        jnp.asarray(depths, jnp.int32), backend="ref",
        conf_backend="pallas_interpret", window=0, fused_exit=fused)
    got = ttf.forward_exits_masked(
        tp, tcfg, {"tokens": torch.as_tensor(data["tokens"])},
        torch.as_tensor(depths), window=0, fused_exit=fused)
    assert got["conf"].shape == (cfg.num_layers, 6)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(ref["conf"]),
                               rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(ref["pred"]))
    np.testing.assert_allclose(got["hidden"].numpy(),
                               np.asarray(ref["hidden"]), rtol=HIDDEN_TOL,
                               atol=HIDDEN_TOL)


# ------------------------------------------------ serve() vs reference

_SERVED = {}


def _served(arch):
    """The bridged smoke model of ``arch`` and alpha in a gap of its
    stream's confidences (built once per module)."""
    if arch not in _SERVED:
        cfg, tcfg, jp, tp = _bridged(arch)
        data = make_dataset("imdb_like", N_SAMPLES, seed=1)
        conf = np.sort(np.asarray(jtf.forward_exits(
            jp, cfg, {"tokens": jnp.asarray(data["tokens"])})["conf"]).ravel())
        lo, hi = len(conf) // 4, 3 * len(conf) // 4
        k = lo + int(np.argmax(np.diff(conf[lo:hi])))
        alpha = float(conf[k] + conf[k + 1]) / 2
        assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
        _SERVED[arch] = cfg, tcfg, jp, tp, alpha
    return _SERVED[arch]


SERVE_CASES = [("elasticbert12", b, side, mode)
               for b, side, mode in ((1, False, "scan"), (8, False, "scan"),
                                     (8, True, "scan"), (32, False, "auto"),
                                     (8, True, "auto"), (32, True, "scan"))]
SERVE_CASES += [("rwkv6-3b", 8, False, "scan"), ("rwkv6-3b", 8, True, "auto"),
                ("rwkv6-3b", 32, True, "scan")]


@pytest.mark.parametrize("arch,batch_size,side_info,edge_mode", SERVE_CASES)
def test_scan_serving_matches_reference(arch, batch_size, side_info,
                                        edge_mode):
    cfg, tcfg, jp, tp, alpha = _served(arch)
    kw = dict(batch_size=batch_size, side_info=side_info,
              edge_mode=edge_mode)
    ref = jserve(JRuntime(cfg, backend="ref",
                          conf_backend="pallas_interpret"), jp,
                 OnlineStream(make_dataset("imdb_like", N_SAMPLES, seed=1),
                              seed=0),
                 JCostModel(num_layers=cfg.num_layers, alpha=alpha,
                            offload=3.0), JConfig(**kw))
    got = serve(EdgeCloudRuntime(tcfg, device="cpu"), tp,
                TStream(t_make_dataset("imdb_like", N_SAMPLES, seed=1),
                        seed=0),
                CostModel(num_layers=tcfg.num_layers, alpha=alpha,
                          offload=3.0), ServingConfig(**kw))
    assert got.path == ref.path == "batched"
    assert got.n == ref.n == N_SAMPLES
    for key in ("arms", "exited", "preds", "exits_per_layer"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got.offload_bytes == ref.offload_bytes
    assert got.accuracy == ref.accuracy
    assert abs(got.cost_total - ref.cost_total) <= 1e-6
    np.testing.assert_allclose(got.rewards, ref.rewards, rtol=0, atol=1e-6)
    assert 0 < ref.exited.sum() < N_SAMPLES


# --------------------------------------- port: scan == bucketed phase

def _forced_arms(b, num_layers, seed=0):
    """An arm vector that mixes >= 3 distinct depths in one batch."""
    arms = np.random.default_rng(seed).integers(0, num_layers, b)
    arms[:3] = [0, 1, 2]
    return arms.astype(np.int64)


def _deeper(tcfg):
    """The smoke config with at least 3 layers, so 3 depths mix."""
    return dataclasses.replace(tcfg, num_layers=max(3, tcfg.num_layers))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("side_info", [False, True])
def test_scan_phase_matches_bucketed_phase(arch, side_info):
    tcfg = _deeper(dataclasses.replace(t_get_smoke_config(arch),
                                       dtype="float32"))
    params = ttf.init_params(tcfg, seed=0, device="cpu")
    rt = EdgeCloudRuntime(tcfg, device="cpu")
    b = 12
    tokens = np.asarray(t_make_dataset("imdb_like", b, seed=2)["tokens"])
    arms = _forced_arms(b, tcfg.num_layers)
    conf = ttf.forward_exits(params, tcfg, {"tokens": torch.as_tensor(
        tokens)})["conf"]
    cost = CostModel(num_layers=tcfg.num_layers, alpha=float(conf.median()),
                     offload=3.0)
    q_b, q_s = OffloadQueue(rt, params), OffloadQueue(rt, params)
    paths_b, preds_b = _edge_phase(rt, params, tokens, arms, cost, q_b,
                                   side_info=side_info)
    paths_s, preds_s = _edge_phase_scan(rt, params, tokens, arms, cost, q_s,
                                        side_info=side_info)
    assert preds_b == preds_s
    for s in range(b):
        assert paths_s[s].shape == ((arms[s] + 1,) if side_info else (1,))
        np.testing.assert_allclose(paths_s[s], paths_b[s], rtol=ULP_RTOL,
                                   atol=ULP_ATOL)
    assert sorted(q_b.rows) == sorted(q_s.rows) and len(q_b) == len(q_s) > 0
    for d in q_b.rows:
        assert q_b.slots[d] == q_s.slots[d]
        assert torch.equal(torch.stack(q_b.rows[d]), torch.stack(q_s.rows[d]))
    assert q_b.flush() == q_s.flush()


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_picks_scan_only_for_mixed_batches(arch, monkeypatch):
    tcfg = _deeper(dataclasses.replace(t_get_smoke_config(arch),
                                       dtype="float32"))
    params = ttf.init_params(tcfg, seed=0, device="cpu")
    b = 6
    tokens = np.asarray(t_make_dataset("imdb_like", b, seed=2)["tokens"])
    cost = CostModel(num_layers=tcfg.num_layers, alpha=0.5, offload=3.0)

    def refuse(*_args, **_kw):
        raise AssertionError("the other edge phase ran")

    for arms, refused in ((np.full(b, 1), "edge_scan_fn"),
                          (_forced_arms(b, tcfg.num_layers), "edge_fn")):
        rt = EdgeCloudRuntime(tcfg, device="cpu")
        want = (_edge_phase if refused == "edge_scan_fn"
                else _edge_phase_scan)(rt, params, tokens, arms, cost,
                                       OffloadQueue(rt, params),
                                       side_info=False)
        monkeypatch.setattr(rt, refused, refuse)
        got = _edge_phase_auto(rt, params, tokens, arms, cost,
                               OffloadQueue(rt, params), side_info=False)
        assert got[1] == want[1]
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)


def test_select_edge_phase_resolution():
    assert EDGE_MODES == ("bucketed", "scan", "auto")
    assert select_edge_phase("bucketed") is _edge_phase
    assert select_edge_phase("scan") is _edge_phase_scan
    assert select_edge_phase("auto") is _edge_phase_auto
    with pytest.raises(ValueError, match="unknown edge_mode 'turbo'"):
        select_edge_phase("turbo")


# ------------------------------------------------------ mask properties

# the fallback's @given cannot take pytest fixtures: a lazily built bed
_BED = {}


def _bed():
    if not _BED:
        tcfg = _deeper(dataclasses.replace(
            t_get_smoke_config("elasticbert12"), dtype="float32"))
        _BED["cfg"] = tcfg
        _BED["params"] = ttf.init_params(tcfg, seed=0, device="cpu")
        _BED["tokens"] = np.asarray(t_make_dataset("imdb_like", 8,
                                                   seed=2)["tokens"])
        _BED["rt"] = EdgeCloudRuntime(tcfg, device="cpu")
    return _BED["cfg"], _BED["params"], _BED["tokens"], _BED["rt"]


def _masked(rt, params, tokens, depths):
    conf, pred, hidden = rt.edge_scan_fn(params, {"tokens": tokens},
                                         torch.as_tensor(depths))
    return conf.numpy(), pred.numpy(), hidden.numpy()


def _poisoned(tree, layers: int, first: int):
    """A copy of the tree with every per-layer float leaf NaN from layer
    ``first`` on."""
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = _poisoned(val, layers, first)
        else:
            val = val.detach().clone()
            if val.ndim and val.shape[0] == layers and val.is_floating_point():
                val[first:] = float("nan")
            out[key] = val
    return out


@given(st.integers(0, 10 ** 6))
@settings(max_examples=6, deadline=None)
def test_outputs_independent_of_layers_past_depth(seed):
    cfg, params, tokens, rt = _bed()
    rng = np.random.default_rng(seed)
    b, n_layers = 6, cfg.num_layers
    depths = rng.integers(0, n_layers - 1, b)   # >= 1 layer to poison
    conf0, pred0, hidden0 = _masked(rt, params, tokens[:b], depths)
    dmax = int(depths.max())
    poisoned = dict(params.items())
    poisoned["layers"] = _poisoned(params["layers"], n_layers, dmax + 1)
    conf1, pred1, hidden1 = _masked(rt, ParamTree(poisoned), tokens[:b],
                                    depths)
    assert np.isnan(conf1[dmax + 1:]).any()      # the poison reached
    np.testing.assert_array_equal(hidden0, hidden1)
    for s in range(b):
        d = int(depths[s])
        np.testing.assert_array_equal(conf0[: d + 1, s], conf1[: d + 1, s])
        np.testing.assert_array_equal(pred0[: d + 1, s], pred1[: d + 1, s])


@given(st.integers(0, 10 ** 6))
@settings(max_examples=6, deadline=None)
def test_padded_rows_never_perturb_live_rows(seed):
    cfg, params, tokens, rt = _bed()
    rng = np.random.default_rng(seed)
    b, live = 8, 5
    depths = rng.integers(0, cfg.num_layers, b)
    tokens = tokens[:b].copy()
    tokens[live:] = tokens[live - 1]
    depths[live:] = depths[live - 1]
    conf0, pred0, hidden0 = _masked(rt, params, tokens, depths)
    tokens2, depths2 = tokens.copy(), depths.copy()
    tokens2[live:] = rng.integers(0, cfg.vocab_size,
                                  (b - live, tokens.shape[1]))
    depths2[live:] = rng.integers(0, cfg.num_layers, b - live)
    conf1, pred1, hidden1 = _masked(rt, params, tokens2, depths2)
    np.testing.assert_array_equal(conf0[:, :live], conf1[:, :live])
    np.testing.assert_array_equal(pred0[:, :live], pred1[:, :live])
    np.testing.assert_array_equal(hidden0[:live], hidden1[:live])
    assert not np.array_equal(hidden0[live:], hidden1[live:])
