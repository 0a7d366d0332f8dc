"""The slice as a whole: the port's SplitEE serving vs the reference's.

Both `EdgeCloudRuntime`s serve the same stream with the same (bridged)
parameters — the port on the CPU through its plain versions, the
reference with its exit kernels in Pallas interpret mode — and must take the
same decisions: arms, exits, preds and offload bytes exactly equal;
cost_total and per-sample rewards within 1e-6.

Exit decisions compare a float32 confidence against alpha, so alpha is
placed in a gap of the stream's confidences, at least 1e-4 from every
confidence any exit produces on this stream; ulp-level differences
between the frameworks cannot then flip a decision.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.core.controller import SplitEEController as JController
from repro.data import OnlineStream, make_dataset
from repro.models.transformer import forward_exits, init_params
from repro.serving.batched import _serve_stream_batched as j_batched
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro.serving.simulator import _serve_stream_sequential as j_sequential
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel, SplitEEController
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.models.transformer import init_params as t_init_params
from repro_torch.serving import (EdgeCloudRuntime, ServingConfig,
                                 _serve_stream_batched,
                                 _serve_stream_sequential, serve)
from repro_torch.serving.batched import OffloadQueue, _pow2

N_SAMPLES = 37          # not a multiple of the batch size 8
# the reference's attention runs its jnp oracle here (its Pallas kernel in
# interpret mode is held against the port in test_torch_flash_attention);
# its exit heads run their Pallas kernels in interpret mode
JAX_BACKEND = "ref"
ALPHA_MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("elasticbert12"),
                              dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                               dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    data = make_dataset("imdb_like", N_SAMPLES, seed=1)
    conf = np.sort(np.asarray(forward_exits(
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
def test_serving_matches_reference(setup, batch_size, side_info, fused_exit):
    cfg, tcfg, jp, tp, alpha = setup
    jrt = JRuntime(cfg, backend=JAX_BACKEND, conf_backend="pallas_interpret",
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
    # both decisions occur, so the comparison covers exits and offloads
    assert 0 < ref["exited"].sum() < N_SAMPLES


@pytest.mark.parametrize("side_info", [False, True])
@pytest.mark.parametrize("batch_size", [1, 5])
def test_controller_bit_identical(side_info, batch_size):
    """The numpy controller copy folds bit-identically to the reference's
    (float32 state, first-index UCB ties)."""
    L = 4
    rng = np.random.default_rng(batch_size)
    kw = dict(num_layers=L, alpha=0.8, offload=2.0)
    ref, got = (JController(JCostModel(**kw), side_info=side_info),
                SplitEEController(CostModel(**kw), side_info=side_info))
    for _ in range(12):
        arms = ref.choose_splits(batch_size)
        np.testing.assert_array_equal(arms, got.choose_splits(batch_size))
        paths = [rng.random(a + 1 if side_info else 1).astype(np.float32)
                 for a in arms]
        conf_L = [None if rng.random() < 0.5 else float(rng.random())
                  for _ in arms]
        obs = [int(x) for x in rng.integers(0, 100, len(arms))]
        np.testing.assert_array_equal(ref.update_batch(arms, paths, conf_L, obs),
                                      got.update_batch(arms, paths, conf_L, obs))
    rs, gs = ref.snapshot(), got.snapshot()
    np.testing.assert_array_equal(rs["q"], gs["q"])
    np.testing.assert_array_equal(rs["n"], gs["n"])
    assert rs["t"] == gs["t"] and ref.totals == got.totals
    assert ref.history == got.history


def test_offload_bytes_follow_activation_dtype():
    tcfg = t_get_smoke_config("elasticbert12")
    rt = EdgeCloudRuntime(tcfg, device="cpu")
    assert rt.offload_bytes(1, 64) == 64 * tcfg.d_model * 2     # bfloat16
    f32 = EdgeCloudRuntime(dataclasses.replace(tcfg, dtype="float32"),
                           device="cpu")
    assert f32.offload_bytes(2, 64) == 2 * 64 * tcfg.d_model * 4


def test_unported_options_raise():
    """Nothing behind `serve()` is unported any more, and nothing falls
    back: the distributed path's runtime resources (``exchange``,
    ``init_state``, ``stream_offset``) on another path raise the
    reference's ``ValueError``, and a distributed config serves (here
    one process over an empty stream: nothing served, nothing folded).
    (The scan edge phase, the offload codec, decode, the sharded and the
    distributed paths are held against the reference in
    tests/test_torch_scan_edge.py, tests/test_torch_offload_codec.py,
    tests/test_torch_decode_serving.py, tests/test_torch_sharded.py and
    tests/test_torch_distributed.py.)"""
    tcfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                               num_layers=1, dtype="float32")
    rt = EdgeCloudRuntime(tcfg, device="cpu")
    cost = CostModel(num_layers=tcfg.num_layers)
    for config, resources, path in (
            (ServingConfig(batch_size=8), {"exchange": object()}, "batched"),
            (ServingConfig(batch_size=8, replicas=2), {"init_state": {}},
             "sharded"),
            (ServingConfig(batch_size=8), {"stream_offset": 3}, "batched")):
        with pytest.raises(ValueError, match=(
                f"exchange/init_state/stream_offset belong to the "
                f"distributed path; this config resolves to '{path}'")):
            serve(rt, None, [], cost, config, **resources)
    rep = serve(rt, t_init_params(tcfg, seed=0, device="cpu"), [], cost,
                ServingConfig(distributed=True))
    assert rep.path == "distributed" and rep.n == 0
    assert rep.distributed == {"num_hosts": 1, "host_id": 0,
                               "local_replicas": 1}


def test_offload_queue_padding_and_flush():
    """`OffloadQueue.flush_async` pads each depth's rows to the next power
    of two and makes one `cloud_fn` call per depth, in depth order;
    `flush()` is ``flush_async().resolve()``; each slot's wire bytes are
    its full-dtype row."""
    tcfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                               dtype="float32")
    params = t_init_params(tcfg, seed=0, device="cpu")
    rt = EdgeCloudRuntime(tcfg, device="cpu")
    shapes = []
    cloud = rt.cloud_fn

    def spy(p, hidden, depth):
        shapes.append((int(depth), hidden.shape[0]))
        return cloud(p, hidden, depth)

    rt.cloud_fn = spy
    rows = torch.randn((5, 8, tcfg.d_model))
    q = OffloadQueue(rt, params)
    assert [_pow2(k) for k in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    q.add_rows(1, rows[:3], [0, 2, 4])
    q.add_rows(0, rows[3:], [1, 3])
    assert len(q) == 5
    first = q.flush_async()
    assert shapes == [(0, 2), (1, 4)] and len(q) == 0
    assert first.slot_bytes == {s: 8 * tcfg.d_model * 4 for s in range(5)}
    assert sorted(first.resolve()) == [0, 1, 2, 3, 4]
    q.add_rows(1, rows[:2], [0, 1])
    assert sorted(q.flush()) == [0, 1] and shapes[-1] == (1, 2)
