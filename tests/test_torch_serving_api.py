"""Port vs reference: the serving front end (`ServingConfig`, `serve()`,
`ServeReport`, `Engine`, `MultiTenantEngine`, `RequestScheduler`).

* every invalid config the reference's API suite lists (and the scan,
  codec, controller and decode ones) raises the reference's exact
  message; JSON written by either package loads in the other; the
  resolved path agrees over a grid of configs;
* `serve()` of the port against the reference's `serve()` on the same
  bridged smoke model (sequential, batched, scan, codec): every
  `ServeReport` field but the wall-clock ones, decisions exactly and
  confidence-derived floats within 1e-6 (1e-3 through the int4 codec);
* an `Engine` fed in ragged chunks with ``scheduler="fifo"`` equals the
  one-shot `serve()`; `MultiTenantEngine` with two tenants (ElasticBERT and
  rwkv6) equals the reference's, scheduler section included, under the
  same fake clock; `RequestScheduler` equals the reference's over a
  random trace of offers, polls and flushes;
* the unported distributed path and its resources raise "not ported
  yet" (the sharded path is held in tests/test_torch_sharded.py); a mesh
  on the batched path raises the reference's error.
"""
import dataclasses
import itertools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.data import OnlineStream, make_dataset
from repro.models.transformer import forward_exits, init_params
from repro.serving.api import MultiTenantEngine as JMultiTenantEngine
from repro.serving.api import ServingConfig as JConfig
from repro.serving.api import TenantSpec as JTenantSpec
from repro.serving.api import serve as jserve
from repro.serving.scheduler import RequestScheduler as JScheduler
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.serving import (EdgeCloudRuntime, Engine, MultiTenantEngine,
                                 RequestScheduler, ServeReport, ServingConfig,
                                 TenantSpec, serve)

N_SAMPLES = 37
ALPHA_MARGIN = 1e-4

INVALID = [
    dict(batch_size=0), dict(replicas=0), dict(replicas=-2),
    dict(overlap_depth=0), dict(beta=0.0), dict(max_samples=-1),
    dict(heartbeat_timeout=0.0), dict(heartbeat_interval=-0.5),
    dict(heartbeat_timeout=0.2, heartbeat_interval=0.5), dict(path="bogus"),
    dict(fault_tolerant=True), dict(record_states=True),
    dict(record_trace=True, path="sequential"),
    dict(record_trace=True, distributed=True),
    dict(distributed=True, path="batched"), dict(scheduler="bogus"),
    dict(shed_policy="bogus"), dict(max_queue=-1),
    dict(batch_deadline_ms=-0.5), dict(max_queue=8),
    dict(batch_deadline_ms=5.0), dict(scheduler="fifo", distributed=True),
    dict(scheduler="fifo", path="distributed"),
    dict(mesh=True, path="batched"), dict(replicas=2, path="batched"),
    dict(batch_size=4, path="sequential"),
    # the edge phase, the codec, the controller, the decode workload
    dict(edge_mode="warp"), dict(edge_mode="scan", path="sequential"),
    dict(edge_mode="auto", distributed=True),
    dict(offload_quant="int2"), dict(offload_sparsity=1.0),
    dict(offload_error_feedback=True),
    dict(workload="decode", max_new_tokens=2, offload_error_feedback=True),
    dict(controller_mode="bogus"), dict(window=-1), dict(window=4),
    dict(discount=0.0), dict(discount=0.5),
    dict(cost_trace={"bogus": 1}), dict(workload="bogus"),
    dict(split_policy="final"), dict(max_new_tokens=-1),
    dict(max_new_tokens=3), dict(workload="decode"),
    dict(workload="decode", max_new_tokens=2, path="batched"),
    dict(workload="decode", max_new_tokens=2, side_info=True),
    dict(workload="decode", max_new_tokens=2, edge_mode="scan"),
]


@pytest.mark.parametrize("kwargs", INVALID,
                         ids=[json.dumps(k, sort_keys=True) for k in INVALID])
def test_invalid_configs_raise_the_reference_message(kwargs):
    with pytest.raises(ValueError) as want:
        JConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        ServingConfig(**kwargs)
    assert str(got.value) == str(want.value)


VALID = [
    dict(), dict(batch_size=16, replicas=2, mesh=True, overlap=False,
                 overlap_depth=3, side_info=True, beta=0.7, max_samples=128,
                 labels_for_accounting=False),
    dict(batch_size=8, scheduler="fifo", max_queue=64, batch_deadline_ms=12.5,
         shed_policy="drop_oldest"),
    dict(path="distributed", fault_tolerant=True, heartbeat_timeout=2.5),
    dict(batch_size=32, edge_mode="scan", offload_quant="int4",
         offload_sparsity=0.5, record_trace=True),
    dict(controller_mode="sliding_window", window=4, record_history=False),
    dict(controller_mode="discounted", discount=0.9, tenant="a"),
    dict(workload="decode", max_new_tokens=4, split_policy="final",
         offload_quant="int8", offload_error_feedback=True),
]


@pytest.mark.parametrize("kwargs", VALID)
def test_json_round_trips_across_packages(kwargs):
    ref, got = JConfig(**kwargs), ServingConfig(**kwargs)
    assert got.to_json() == ref.to_json()
    assert ServingConfig.from_json(ref.to_json()) == got
    assert JConfig.from_json(got.to_json()) == ref
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_from_json_rejects_what_the_reference_rejects():
    for text in ('{"replicaz": 2, "batch_size": 8}', "[1, 2]"):
        with pytest.raises(ValueError) as want:
            JConfig.from_json(text)
        with pytest.raises(ValueError) as got:
            ServingConfig.from_json(text)
        assert str(got.value) == str(want.value)


def test_resolved_path_matches_reference_over_a_grid():
    grid = itertools.product(
        ("auto", "sequential", "batched", "sharded", "distributed"),
        (1, 8), (1, 2), (False, True), (False, True),
        ("bucketed", "scan", "auto"), (False, True), ("classify", "decode"))
    n = 0
    for path, b, r, mesh, dist, mode, trace, work in grid:
        kw = dict(path=path, batch_size=b, replicas=r, mesh=mesh,
                  distributed=dist, edge_mode=mode, record_trace=trace,
                  workload=work, max_new_tokens=2 if work == "decode" else 0)
        try:
            want = JConfig(**kw).resolved_path()
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                ServingConfig(**kw)
            assert str(got.value) == str(e)
            continue
        assert ServingConfig(**kw).resolved_path() == want
        n += 1
    assert n >= 20


# ---------------------------------------------- serve() vs reference

@pytest.fixture(scope="module")
def bed():
    out = {}
    for arch in ("elasticbert12", "rwkv6-3b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(t_get_smoke_config(arch), dtype="float32")
        jp = init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        data = make_dataset("imdb_like", N_SAMPLES, seed=1)
        conf = np.sort(np.asarray(forward_exits(
            jp, cfg, {"tokens": jnp.asarray(data["tokens"])})["conf"]).ravel())
        lo, hi = len(conf) // 4, 3 * len(conf) // 4
        k = lo + int(np.argmax(np.diff(conf[lo:hi])))
        alpha = float(conf[k] + conf[k + 1]) / 2
        assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
        out[arch] = dict(
            jrt=JRuntime(cfg, backend="ref", conf_backend="pallas_interpret"),
            trt=EdgeCloudRuntime(tcfg, device="cpu"), jp=jp, tp=tp,
            jcost=JCostModel(num_layers=cfg.num_layers, alpha=alpha,
                             offload=3.0),
            tcost=CostModel(num_layers=tcfg.num_layers, alpha=alpha,
                            offload=3.0))
    return out


def _streams():
    return (OnlineStream(make_dataset("imdb_like", N_SAMPLES, seed=1), seed=0),
            TStream(t_make_dataset("imdb_like", N_SAMPLES, seed=1), seed=0))


FLOAT_FIELDS = ("cost_total", "offload_frac", "accuracy")
WALL_FIELDS = ("wall_s", "samples_per_sec")


def _assert_reports_match(got, ref, atol=1e-6):
    """Every ServeReport field but the wall-clock ones: decisions exactly,
    confidence-derived floats within ``atol``."""
    assert isinstance(got, ServeReport)
    assert sorted(got.keys()) == sorted(ref.keys())
    for f in dataclasses.fields(ref):
        name = f.name
        a, b = getattr(got, name), getattr(ref, name)
        if name in WALL_FIELDS:
            assert (a is None) == (b is None), name
        elif name == "rewards":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        elif name == "state":
            np.testing.assert_allclose(a["q"], b["q"], rtol=0, atol=atol)
            np.testing.assert_array_equal(a["n"], b["n"])
            assert a["t"] == b["t"] and sorted(a) == sorted(b)
        elif name == "trace":
            assert (a is None) == (b is None)
            if a is not None:
                for pa, pb in zip(a["conf_path"], b["conf_path"]):
                    np.testing.assert_allclose(pa, pb, rtol=0, atol=atol)
                for ca, cb in zip(a["conf_L"], b["conf_L"]):
                    assert (ca is None) == (cb is None)
                    if ca is not None:
                        assert abs(ca - cb) <= atol
        elif name in FLOAT_FIELDS:
            assert (a is None) == (b is None), name
            if a is not None:
                assert abs(a - b) <= atol, name
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


# through the codec, the cloud's confidences (rewards, q) may differ by
# more than float32 rounding: the two frameworks' edge hidden rows differ
# in their last bits, which can move an element across a rounding boundary
# of the int4 grid, one quantum (1/15 of a channel's range) at the cloud's
# input. The codec itself is bitwise (test_torch_offload_codec.py), and the
# decisions and bytes are compared exactly.
CODEC_FLOAT_ATOL = 1e-3


@pytest.mark.parametrize("kwargs,atol", [
    (dict(max_samples=20), 1e-6),                               # sequential
    (dict(batch_size=8, record_trace=True), 1e-6),
    (dict(batch_size=8, edge_mode="scan", side_info=True, record_trace=True),
     1e-6),
    (dict(batch_size=8, edge_mode="scan", offload_quant="int4",
          offload_sparsity=0.5), CODEC_FLOAT_ATOL),
])
def test_serve_matches_reference(bed, kwargs, atol):
    b = bed["elasticbert12"]
    js, ts = _streams()
    ref = jserve(b["jrt"], b["jp"], js, b["jcost"], JConfig(**kwargs))
    got = serve(b["trt"], b["tp"], ts, b["tcost"], ServingConfig(**kwargs))
    assert got.path == ref.path
    _assert_reports_match(got, ref, atol)
    assert got.samples_per_sec > 0 and got.wall_s > 0


def test_engine_ragged_fifo_equals_one_shot_serve(bed):
    b = bed["elasticbert12"]
    config = ServingConfig(batch_size=8, edge_mode="scan", max_samples=N_SAMPLES)
    samples = list(_streams()[1])
    ref = serve(b["trt"], b["tp"], iter(samples), b["tcost"], config)
    eng = Engine(b["trt"], b["tp"], b["tcost"],
                 dataclasses.replace(config, scheduler="fifo"))
    i = 0
    for chunk in (5, 1, 7, 3, 16, 2, 30):
        eng.submit(samples[i:i + chunk])
        i += chunk
    assert eng.submitted == N_SAMPLES and eng.shed == 0
    got = eng.close()
    assert eng.close() is got and eng.closed
    for key in ("arms", "exited", "preds", "rewards"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got.offload_bytes == ref.offload_bytes and got.n == ref.n
    sched = got.scheduler
    assert sched["served"] == N_SAMPLES and sched["pending"] == 0
    assert sched["latency_ms"]["count"] == N_SAMPLES
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(samples[:1])


def _fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def test_multi_tenant_engine_matches_reference(bed):
    def tenants(side):
        out = {}
        for name, arch, bsz in (("cls", "elasticbert12", 8),
                                ("lm", "rwkv6-3b", 4)):
            b = bed[arch]
            if side == "jax":
                out[name] = JTenantSpec(b["jrt"], b["jp"], b["jcost"],
                                        JConfig(batch_size=bsz))
            else:
                out[name] = TenantSpec(b["trt"], b["tp"], b["tcost"],
                                       ServingConfig(batch_size=bsz))
        return out

    ref_eng = JMultiTenantEngine(tenants("jax"), batch_deadline_ms=2.0,
                                 tenant_quota={"lm": 6}, clock=_fake_clock())
    got_eng = MultiTenantEngine(tenants("torch"), batch_deadline_ms=2.0,
                                tenant_quota={"lm": 6}, clock=_fake_clock())
    jsamples, tsamples = (list(s)[:24] for s in _streams())
    for i in range(0, 24, 3):
        for name in ("cls", "lm"):
            assert got_eng.submit(name, tsamples[i:i + 3]) == \
                ref_eng.submit(name, jsamples[i:i + 3])
        assert got_eng.tick() == ref_eng.tick()
    ref, got = ref_eng.close(), got_eng.close()
    assert sorted(got) == sorted(ref) == ["cls", "lm"]
    for name in ref:
        _assert_reports_match(got[name], ref[name])
        assert got[name].tenant == name


def test_request_scheduler_matches_reference():
    rng = np.random.default_rng(7)
    kw = dict(batch_size=4, max_queue=10, batch_deadline_ms=3.0,
              shed_policy="drop_oldest", tenant_batch_size={"b": 2},
              tenant_quota={"b": 3})
    ref, got = JScheduler(**kw), RequestScheduler(**kw)
    now = 0.0
    for step in range(200):
        now += float(rng.exponential(0.7)) * 1e-3
        op = rng.random()
        if op < 0.6:
            tenant = [None, "a", "b"][int(rng.integers(3))]
            prio = int(rng.integers(0, 3))
            dl = None if rng.random() < 0.5 else float(rng.uniform(0.5, 6))
            args = dict(priority=prio, deadline_ms=dl, now=now,
                        tenant=tenant)
            assert got.offer({"i": step}, **args) == \
                ref.offer({"i": step}, **args)
        elif op < 0.9:
            gb, rb = got.poll(now), ref.poll(now)
            assert [[r.seq for r in x] for x in gb] == \
                [[r.seq for r in x] for x in rb]
            for x, y in zip(gb, rb):
                got.complete(x, now)
                ref.complete(y, now)
        else:
            assert got.next_fire(now) == ref.next_fire(now)
        assert got.pending == ref.pending
    gb, rb = got.flush(now + 1.0), ref.flush(now + 1.0)
    assert [[r.seq for r in x] for x in gb] == [[r.seq for r in x] for x in rb]
    assert got.snapshot() == ref.snapshot()
    assert got.shed > 0 and got.served > 0


NOT_PORTED = (NotImplementedError, "not ported yet")
UNPORTED = [
    # the sharded path runs; the distributed path's resources do not
    (dict(replicas=2), dict(exchange=object()), NOT_PORTED),
    (dict(mesh=True), dict(init_state={}), NOT_PORTED),
    (dict(path="sharded"), dict(stream_offset=4), NOT_PORTED),
    (dict(distributed=True), {}, NOT_PORTED),
    # decode is ported: a classifier runtime under a decode config raises
    # the reference's type error
    (dict(workload="decode", max_new_tokens=2), {},
     (TypeError, "workload='decode' needs a DecodeRuntime")),
    # a mesh on the batched path: the reference's error
    (dict(batch_size=8), dict(mesh=object()),
     (ValueError, "an explicit mesh applies to the sharded/distributed "
                  "paths; this config resolves to 'batched'")),
    (dict(batch_size=8), dict(exchange=object()), NOT_PORTED),
    (dict(batch_size=8), dict(init_state={}), NOT_PORTED),
    (dict(batch_size=8), dict(stream_offset=4), NOT_PORTED),
]


@pytest.mark.parametrize("kwargs,resources,expect", UNPORTED)
def test_unported_paths_raise(bed, kwargs, resources, expect):
    b = bed["elasticbert12"]
    config = ServingConfig(**kwargs)
    exc, match = expect
    with pytest.raises(exc, match=match):
        serve(b["trt"], b["tp"], _streams()[1], b["tcost"], config,
              **resources)
    if not resources and config.resolved_path() != "distributed":
        with pytest.raises(exc, match=match):
            Engine(b["trt"], b["tp"], b["tcost"], config)


def test_report_dict_surface():
    raw = {"n": 3, "preds": [1, 0, 1], "cost_total": 2.0,
           "offload_frac": 1 / 3, "offload_bytes": 8, "arms": [0, 1, 1],
           "rewards": [0.1, 0.2, 0.3], "exited": [1, 1, 0], "batch_size": 2}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ServeReport.from_raw(dict(raw), path="batched", num_layers=3,
                                   wall_s=0.5)
    from repro.serving.api import ServeReport as JReport
    ref = JReport.from_raw(dict(raw), path="batched", num_layers=3,
                           wall_s=0.5)
    assert sorted(got.keys()) == sorted(ref.keys())
    np.testing.assert_array_equal(got["exits_per_layer"], [1, 1, 0])
    assert got.samples_per_sec == ref.samples_per_sec == 6.0
    assert "trace" not in got and got.get("trace", 7) == 7
    assert len(got) == len(ref)
