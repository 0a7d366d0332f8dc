"""Port vs reference: the sharded serving runtime (serving/sharded.py), its
mesh (launch/mesh.py) and placement (launch/shardings.py,
sharding/rules.py), and the batched-module pieces only it sets
(`_bucket_cap`, `OffloadQueue.flush_async(min_rows=, depth=)`,
``put=``/``replicas=`` in the edge phases).

* pure functions equal the reference's: `_bucket_cap`, `_shard_sizes`,
  `sanitize_spec`, `param_specs` leaf for leaf for every arch's smoke
  parameters, `param_shardings`;
* the offload queue's flush ring and `_PipelineDriver`'s fold order and
  delay bound equal the reference's on the same rows and callbacks;
* one replica with overlap off is bitwise the port's batched path;
* `serve(path="sharded")` equals the reference's on the same bridged smoke
  model (ElasticBERT-12 smoke, f32) at R = 1 (overlap off, K = 1, K = 2,
  SplitEE-S, scan, int8); R = 2 and 4 (CPU replicas) equal R = 1 and the
  reference, and R = 4 equals the reference's own 4-device run (forced
  host devices, in a subprocess); decisions exactly, floats within 1e-6
  (1e-3 through a codec);
* `Engine` / `MultiTenantEngine` over the sharded path equal the one-shot
  `serve()` and the reference's engines;
* the mesh errors: the reference's messages where it has them; a "model"
  axis, a mesh on other devices than the parameters' and a CUDA mesh on
  a CPU-only host raise, and nothing falls back.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.data import OnlineStream, make_dataset
from repro.launch import mesh as jmesh
from repro.launch import shardings as jshardings
from repro.models.api import build_model as j_build_model
from repro.models.transformer import forward_exits, init_params
from repro.serving import batched as jbatched
from repro.serving import sharded as jsharded
from repro.serving.api import Engine as JEngine
from repro.serving.api import MultiTenantEngine as JMultiTenantEngine
from repro.serving.api import ServingConfig as JConfig
from repro.serving.api import TenantSpec as JTenantSpec
from repro.serving.api import serve as jserve
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro.sharding import rules as jrules
from repro_torch.bridge import params_from_jax
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.launch import shardings as tshardings
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models.api import build_model as t_build_model
from repro_torch.serving import (EdgeCloudRuntime, Engine, MultiTenantEngine,
                                 ServingConfig, TenantSpec, serve)
from repro_torch.serving import batched as tbatched
from repro_torch.serving import sharded as tsharded
from repro_torch.sharding import rules as trules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = 37          # not a multiple of the batch size 8
ALPHA_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size calls run on one intra-op thread: under the suite's
    parallel workers, torch's default pool (one thread per core in every
    worker) oversubscribes the cores and makes these many small calls
    several times slower. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# through the codec the cloud's confidences may move by one quantum of the
# int8 grid (the edge rows differ in their last bits between frameworks);
# decisions and bytes are compared exactly (as test_torch_serving_api.py)
CODEC_FLOAT_ATOL = 1e-3


# ------------------------------------------------------- pure functions

def test_bucket_cap_and_shard_sizes_match_reference():
    for k in range(1, 65):
        assert tbatched._bucket_cap(k, 1) == tbatched._pow2(k)
        for m in range(1, 6):
            assert tbatched._bucket_cap(k, m) == jbatched._bucket_cap(k, m)
    for total in range(0, 41):
        for r in range(1, 6):
            assert tsharded._shard_sizes(total, r) == \
                jsharded._shard_sizes(total, r)


SPEC_CASES = [
    ({"data": 4}, ("data", None), (8, 3)),
    ({"data": 4}, ("data", None), (6, 3)),
    ({"data": 4}, ("data",), (12, 5, 7)),
    ({"data": 3, "model": 2}, (None, "model"), (5, 6)),
    ({"data": 3, "model": 2}, (("data", "model"), None), (12, 1)),
    ({"data": 3, "model": 2}, (("data", "model"), None), (9, 1)),
    ({"data": 2, "model": 2}, ("model", "data", None), (4, 3, 2)),
    ({"data": 1}, (), (3,)),
]


@pytest.mark.parametrize("axes,spec,shape", SPEC_CASES)
def test_sanitize_spec_matches_reference(axes, spec, shape):
    want = jshardings.sanitize_spec(types.SimpleNamespace(shape=axes),
                                    P(*spec), shape)
    mesh = ServingMesh(np.full(tuple(axes.values()), "cpu", dtype=object),
                       tuple(axes))
    assert tshardings.sanitize_spec(mesh, spec, shape) == tuple(want)


def _flat_specs(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat_specs(val, prefix + (key,)))
        else:
            out["/".join(prefix + (key,))] = val
    return out


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    return {jrules._path_str(path): leaf for path, leaf in leaves}


AXIS_MAPS = [(None, None), ({"model": None, "fsdp": None}, None),
             ({"model": "model", "fsdp": "data"}, r"moe|embed|exit_w")]


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_param_specs_match_reference(arch):
    """Leaf for leaf over every arch's smoke parameters, with the default
    and custom axis maps and an fsdp_paths filter; then the placements
    over a (1, 1) ("data", "model") mesh."""
    abstract = j_build_model(get_smoke_config(arch)).abstract_params()
    params = t_build_model(t_get_smoke_config(arch)).init(seed=0,
                                                          device="cpu")
    for axis_map, fsdp in AXIS_MAPS:
        want = {k: tuple(v) for k, v in _ref_flat(
            jrules.param_specs(abstract, axis_map, fsdp)).items()}
        got = _flat_specs(trules.param_specs(params, axis_map, fsdp))
        assert got == want
    jm = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    tm = ServingMesh(np.full((1, 1), "cpu", dtype=object), ("data", "model"))
    want = {jrules._path_str(k): tuple(v.spec) for k, v in
            jax.tree_util.tree_flatten_with_path(
                jshardings.param_shardings(jm, abstract))[0]}
    got = {k: v.spec for k, v in _flat_specs(
        tshardings.param_shardings(tm, params)).items()}
    assert got == want


# ---------------------------------------------------- queue and driver

class _FakeCloud:
    """A runtime whose `cloud_fn` records (depth, rows) and returns each
    row's sum as its confidence and the depth as its prediction."""

    def __init__(self, xp):
        self.xp, self.calls = xp, []

    def cloud_fn(self, params, hidden, depth):
        self.calls.append((int(depth), int(hidden.shape[0])))
        if self.xp == "jax":
            return (jnp.sum(hidden, axis=(1, 2)),
                    jnp.full((hidden.shape[0],), depth, jnp.int32))
        return (hidden.sum((1, 2)),
                torch.full((hidden.shape[0],), int(depth)))


@pytest.mark.parametrize("min_rows,depth", [(1, None), (1, 1), (2, 2),
                                            (3, 1), (4, 3)])
def test_flush_async_ring_matches_reference(min_rows, depth):
    """Padded caps and one call per depth, the in-flight ring resolving
    the oldest flush FIFO once more than `depth` are out, `resolve`
    idempotent, `len` and the byte accounting: as the reference's queue
    on the same rows."""
    rng = np.random.default_rng(3)
    jfake, tfake = _FakeCloud("jax"), _FakeCloud("torch")
    jq = jbatched.OffloadQueue(jfake, None)
    tq = tbatched.OffloadQueue(tfake, None)
    jpend, tpend = [], []
    for step in range(5):
        for d in range(int(rng.integers(1, 4))):
            k = int(rng.integers(1, 6))
            rows = rng.standard_normal((k, 4, 3)).astype(np.float32)
            slots = [int(s) for s in rng.choice(32, k, replace=False)]
            jq.add_rows(d, rows, slots)
            tq.add_rows(d, torch.from_numpy(rows), slots)
        assert len(tq) == len(jq)
        jpend.append(jq.flush_async(min_rows=min_rows, depth=depth))
        tpend.append(tq.flush_async(min_rows=min_rows, depth=depth))
        assert tfake.calls == jfake.calls and len(tq) == 0
        assert [p.resolved for p in tpend] == [p.resolved for p in jpend]
        assert [len(p) for p in tpend] == [len(p) for p in jpend]
        assert tpend[-1].slot_bytes == jpend[-1].slot_bytes
    if depth is not None:
        assert sum(not p.resolved for p in tpend) == depth
    for tp, jp in zip(tpend, jpend):
        got = tp.resolve()
        assert tp.resolve() is got and tp.resolved
        want = jp.resolve()
        assert sorted(got) == sorted(want)
        for s in want:
            assert got[s][1] == want[s][1]
            assert abs(got[s][0] - want[s][0]) <= 1e-5


def test_flush_async_rejects_depth_below_one():
    with pytest.raises(ValueError) as want:
        jbatched.OffloadQueue(_FakeCloud("jax"), None).flush_async(depth=0)
    with pytest.raises(ValueError) as got:
        tbatched.OffloadQueue(_FakeCloud("torch"), None).flush_async(depth=0)
    assert str(got.value) == str(want.value)


def _drive_ctx(mod, batch, start):
    return mod._BatchCtx(arms=np.zeros(len(batch), int), conf_paths=[],
                         batch_preds=[], labels=[], seq_len=1, pending=None,
                         start=start)


def _drive(mod, overlap, depth, sizes, batch_size):
    log = []

    def finalize(ctx):
        log.append((ctx.start, len(ctx.arms), ctx.overlapped))

    driver = mod._PipelineDriver(
        batch_size=batch_size, overlap=overlap, overlap_depth=depth,
        process_batch=lambda b, s: _drive_ctx(mod, b, s), finalize=finalize)
    for n in sizes:
        driver.push(list(range(n)))
        log.append(("pushed", len(driver.inflight)))
    driver.drain()
    return log, driver.batches


@pytest.mark.parametrize("overlap,depth", [(False, 1), (True, 1), (True, 2),
                                           (True, 3)])
def test_pipeline_driver_matches_reference(overlap, depth):
    """Fold order, the overlapped flags and the in-flight ring of the
    depth-K schedule over micro-batches with a ragged tail, and
    `_drive_pipeline`'s batch count."""
    sizes = [8, 8, 8, 8, 5]
    assert _drive(tsharded, overlap, depth, sizes, 8) == \
        _drive(jsharded, overlap, depth, sizes, 8)
    stream = [{"i": i} for i in range(37)]
    kw = dict(batch_size=8, max_samples=0, overlap=overlap,
              overlap_depth=depth, finalize=lambda ctx: None)
    assert tsharded._drive_pipeline(
        stream, process_batch=lambda b, s: _drive_ctx(tsharded, b, s),
        **kw) == jsharded._drive_pipeline(
        stream, process_batch=lambda b, s: _drive_ctx(jsharded, b, s),
        **kw) == 5


def test_pipeline_driver_delay_bound_asserts_as_reference():
    """Batches larger than the declared batch size break the (K+1)*B-1
    feedback-delay bound at a fold: both drivers assert, with one
    message."""
    errors = []
    for mod in (jsharded, tsharded):
        with pytest.raises(AssertionError) as err:
            _drive(mod, True, 1, [4, 4, 4], 2)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "feedback delay" in errors[0]


# ------------------------------------------------------- served streams

@pytest.fixture(scope="module")
def bed():
    out = {}
    for arch in ("elasticbert12", "rwkv6-3b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = dataclasses.replace(t_get_smoke_config(arch), dtype="float32")
        jp = init_params(cfg, jax.random.PRNGKey(0))
        npp = jax.tree.map(np.asarray, jp)
        tp = params_from_jax(npp, device="cpu")
        data = make_dataset("imdb_like", N_SAMPLES, seed=1)
        conf = np.sort(np.asarray(forward_exits(
            jp, cfg, {"tokens": jnp.asarray(data["tokens"])})["conf"]).ravel())
        lo, hi = len(conf) // 4, 3 * len(conf) // 4
        k = lo + int(np.argmax(np.diff(conf[lo:hi])))
        alpha = float(conf[k] + conf[k + 1]) / 2
        assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
        out[arch] = dict(
            jrt=JRuntime(cfg, backend="ref", conf_backend="pallas_interpret"),
            trt=EdgeCloudRuntime(tcfg, device="cpu"), jp=jp, npp=npp, tp=tp,
            alpha=alpha,
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


def _assert_reports_match(got, ref, atol=1e-6, skip=()):
    """Every report field but the wall-clock ones (and ``skip``):
    decisions exactly, confidence-derived floats within ``atol``."""
    for f in dataclasses.fields(ref):
        name = f.name
        if name in skip:
            continue
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


def _assert_bitwise(got, ref, skip=()):
    """Two reports of the port: every field but the wall-clock ones (and
    ``skip``) bit for bit."""
    for f in dataclasses.fields(got):
        if f.name in WALL_FIELDS + tuple(skip):
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "state":
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        elif f.name == "trace":
            assert (a is None) == (b is None)
            if a is not None:
                for pa, pb in zip(a["conf_path"], b["conf_path"]):
                    np.testing.assert_array_equal(pa, pb)
                assert a["conf_L"] == b["conf_L"]
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("edge_mode", ["bucketed", "scan", "auto"])
@pytest.mark.parametrize("batch_size", [1, 8])
@pytest.mark.parametrize("side_info", [False, True])
def test_r1_sync_is_bitwise_the_batched_path(bed, edge_mode, batch_size,
                                             side_info):
    """One replica with overlap off makes the batched path's calls on the
    same tensors: every field bit for bit (the sharded report adds
    ``replicas`` and ``overlap``)."""
    b = bed["elasticbert12"]
    if batch_size == 1 and edge_mode != "bucketed":
        kw = dict(batch_size=1, edge_mode=edge_mode, side_info=side_info,
                  record_trace=True, max_samples=20)
    else:
        kw = dict(batch_size=batch_size, edge_mode=edge_mode,
                  side_info=side_info, record_trace=True)
    ref = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                ServingConfig(path="batched", **kw))
    got = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                ServingConfig(path="sharded", overlap=False, **kw))
    assert (ref.path, got.path) == ("batched", "sharded")
    _assert_bitwise(got, ref, skip=("path", "replicas", "overlap"))
    assert got.replicas == 1
    assert got.overlap == {"enabled": False, "depth": 1,
                           "batches": -(-got.n // batch_size),
                           "batches_overlapped": 0}


REF_CASES = {
    "sync": (dict(overlap=False), 1e-6),
    "K=1": (dict(overlap_depth=1), 1e-6),
    "K=2": (dict(overlap_depth=2), 1e-6),
    "side_info K=1": (dict(side_info=True, record_trace=True), 1e-6),
    "scan K=2": (dict(edge_mode="scan", overlap_depth=2), 1e-6),
    "int8 K=1": (dict(offload_quant="int8"), CODEC_FLOAT_ATOL),
}


def _ref_sharded(b, kw):
    return jserve(b["jrt"], b["jp"], _streams()[0], b["jcost"],
                  JConfig(path="sharded", batch_size=8, **kw))


@pytest.mark.parametrize("case", list(REF_CASES))
def test_sharded_matches_reference(bed, case):
    """`serve(path="sharded")` at R = 1 against the reference's."""
    kw, atol = REF_CASES[case]
    b = bed["elasticbert12"]
    ref = _ref_sharded(b, kw)
    got = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                ServingConfig(path="sharded", batch_size=8, **kw))
    assert got.path == ref.path == "sharded"
    _assert_reports_match(got, ref, atol)
    if kw.get("overlap", True):
        assert got.overlap["batches_overlapped"] == got.overlap["batches"] - 1


@pytest.mark.parametrize("replicas", [2, 4])
@pytest.mark.parametrize("case", ["sync", "K=2", "scan K=2"])
def test_replicas_match_one_replica_and_reference(bed, replicas, case):
    """R CPU replicas: R calls a launch over contiguous row chunks, the
    controller fed R shard summaries. The replica count leaves the policy
    unchanged: equal to the port's R = 1 and to the reference's R = 1."""
    kw, atol = REF_CASES[case]
    b = bed["elasticbert12"]
    one = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                ServingConfig(path="sharded", batch_size=8, **kw))
    got = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                ServingConfig(batch_size=8, replicas=replicas, **kw))
    assert got.path == "sharded" and got.replicas == replicas
    _assert_reports_match(got, one, atol, skip=("replicas",))
    _assert_reports_match(got, _ref_sharded(b, kw), atol, skip=("replicas",))


def test_replicas_below_the_mesh_data_axis(bed):
    """replicas=2 on a 4-replica mesh: caps are multiples of 2, so a cap
    that does not divide the data axis falls back to one call on replica
    0 (`sanitize_spec`) and one that does is split four ways; the policy
    equals R = 1. Every replica shares the one CPU parameter tree."""
    b = bed["elasticbert12"]
    mesh = make_serving_mesh(4, device="cpu")
    config = ServingConfig(batch_size=8, replicas=2, overlap=False)
    sess = tsharded._ShardedSession(b["trt"], b["tp"], b["tcost"],
                                    replicas=2, mesh=mesh)
    assert all(p is b["tp"] for p in sess.params) and len(sess.params) == 4
    put = sess.put
    assert [len(put(np.zeros((n, 3))).parts) for n in (2, 4, 6, 8)] == \
        [1, 4, 1, 4]
    one = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                ServingConfig(path="sharded", batch_size=8, overlap=False))
    got = serve(b["trt"], b["tp"], _streams()[1], b["tcost"], config,
                mesh=mesh)
    assert got.replicas == 2
    _assert_reports_match(got, one, skip=("replicas",))


_REF_R4 = textwrap.dedent("""
    import dataclasses, json, sys
    import jax
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.core import CostModel
    from repro.data import OnlineStream, make_dataset
    from repro.serving.api import ServingConfig, serve
    from repro.serving.simulator import EdgeCloudRuntime

    assert len(jax.devices()) == 4, jax.devices()
    args = json.loads(sys.argv[1])
    flat = np.load(args["weights"])
    params = {}
    for key in flat.files:
        *head, leaf = key.split("/")
        node = params
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = flat[key]
    cfg = dataclasses.replace(get_smoke_config("elasticbert12"),
                              dtype="float32")
    rt = EdgeCloudRuntime(cfg, backend="ref",
                          conf_backend="pallas_interpret")
    cost = CostModel(num_layers=cfg.num_layers, alpha=args["alpha"],
                     offload=3.0)
    out = {}
    for name, kw in args["runs"].items():
        rep = serve(rt, params, OnlineStream(make_dataset(
            "imdb_like", args["n"], seed=1), seed=0), cost,
            ServingConfig(**kw))
        for key in ("arms", "exited", "preds", "rewards"):
            out[f"{name}/{key}"] = np.asarray(rep[key])
        out[f"{name}/scalars"] = np.asarray(
            [rep.cost_total, rep.offload_bytes, rep.replicas,
             rep.overlap["batches_overlapped"]], np.float64)
    np.savez(args["out"], **out)
    print("REF_R4_OK")
""")


def test_four_replicas_match_the_reference_four_device_run(bed, tmp_path):
    """The reference at R = 4 over 4 forced host devices (a subprocess:
    the device count must precede jax's start), on the same weights passed
    as .npz; the port's R = 4 on CPU replicas is held to it."""
    b = bed["elasticbert12"]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                b["npp"])[0]}
    np.savez(tmp_path / "w.npz", **flat)
    runs = {"sync": dict(batch_size=8, replicas=4, overlap=False),
            "scan K=2": dict(batch_size=8, replicas=4, edge_mode="scan",
                             overlap_depth=2)}
    args = dict(weights=str(tmp_path / "w.npz"), out=str(tmp_path / "r.npz"),
                alpha=b["alpha"], n=N_SAMPLES, runs=runs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    proc = subprocess.run([sys.executable, "-c", _REF_R4, json.dumps(args)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0 and "REF_R4_OK" in proc.stdout, \
        proc.stderr[-4000:]
    ref = np.load(tmp_path / "r.npz")
    for name, kw in runs.items():
        got = serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
                    ServingConfig(**kw))
        for key in ("arms", "exited", "preds"):
            np.testing.assert_array_equal(got[key], ref[f"{name}/{key}"])
        np.testing.assert_allclose(got.rewards, ref[f"{name}/rewards"],
                                   rtol=0, atol=1e-6)
        cost_total, offload_bytes, replicas, overlapped = \
            ref[f"{name}/scalars"]
        assert abs(got.cost_total - cost_total) <= 1e-5
        assert (got.offload_bytes, got.replicas,
                got.overlap["batches_overlapped"]) == \
            (offload_bytes, replicas, overlapped)


# ----------------------------------------------------------- engines

def test_engine_sharded_equals_one_shot_and_reference(bed):
    """An `Engine` over the sharded path (K = 2, R = 2 CPU replicas of an
    explicit mesh), fed in ragged chunks, equals the one-shot `serve()`
    bit for bit and the reference's `Engine` (R = 1)."""
    b = bed["elasticbert12"]
    config = ServingConfig(path="sharded", batch_size=8, overlap_depth=2,
                           replicas=2)
    one = serve(b["trt"], b["tp"], _streams()[1], b["tcost"], config)
    mesh = make_serving_mesh(2, device="cpu")
    eng = Engine(b["trt"], b["tp"], b["tcost"], config, mesh=mesh)
    jeng = JEngine(b["jrt"], b["jp"], b["jcost"],
                   JConfig(path="sharded", batch_size=8, overlap_depth=2))
    tsamples, jsamples = list(_streams()[1]), list(_streams()[0])
    i = 0
    for chunk in (5, 1, 7, 3, 16, 5):
        eng.submit(tsamples[i:i + chunk])
        jeng.submit(jsamples[i:i + chunk])
        i += chunk
    assert eng.pending == jeng.pending == 5
    got, ref = eng.close(), jeng.close()
    assert got.path == "sharded" and got.n == N_SAMPLES
    _assert_bitwise(got, one, skip=())
    _assert_reports_match(got, ref, skip=("replicas",))
    assert got.overlap == ref.overlap


def test_multi_tenant_engine_over_sharded_sessions_matches_reference(bed):
    """Two tenants (ElasticBERT at K = 1 over 2 CPU replicas, rwkv6 at
    K = 2) behind one shared scheduler: each drained at close, equal to
    the reference's tenants (R = 1)."""
    specs = {"cls": ("elasticbert12", dict(batch_size=8, mesh=True)),
             "lm": ("rwkv6-3b", dict(batch_size=4, path="sharded",
                                     overlap_depth=2))}

    def tenants(side):
        out = {}
        for name, (arch, kw) in specs.items():
            b = bed[arch]
            if side == "jax":
                out[name] = JTenantSpec(b["jrt"], b["jp"], b["jcost"],
                                        JConfig(**kw))
            else:
                if name == "cls":
                    kw = dict(kw, replicas=2)
                out[name] = TenantSpec(b["trt"], b["tp"], b["tcost"],
                                       ServingConfig(**kw))
        return out

    ticks = [iter(range(10 ** 6)) for _ in range(2)]
    ref_eng = JMultiTenantEngine(tenants("jax"), batch_deadline_ms=2.0,
                                 clock=lambda: next(ticks[0]) * 1e-3)
    got_eng = MultiTenantEngine(tenants("torch"), batch_deadline_ms=2.0,
                                clock=lambda: next(ticks[1]) * 1e-3)
    jsamples, tsamples = (list(s)[:24] for s in _streams())
    for i in range(0, 24, 3):
        for name in specs:
            assert got_eng.submit(name, tsamples[i:i + 3]) == \
                ref_eng.submit(name, jsamples[i:i + 3])
        assert got_eng.tick() == ref_eng.tick()
    ref, got = ref_eng.close(), got_eng.close()
    for name in specs:
        assert got[name].path == "sharded" and got[name].n == 24
        _assert_reports_match(got[name], ref[name], skip=("replicas",))
    assert got["cls"].replicas == 2


# ------------------------------------------------------------- errors

def _raises_like(ref_call, got_call, exc=ValueError):
    with pytest.raises(exc) as want:
        ref_call()
    with pytest.raises(exc) as got:
        got_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_mesh_errors_match_reference(bed):
    b = bed["elasticbert12"]
    js, ts = _streams()
    jone, tone = jmesh.make_serving_mesh(1), make_serving_mesh(1,
                                                               device="cpu")
    # a mesh on a path other than sharded/distributed: serve() and Engine
    _raises_like(
        lambda: jserve(b["jrt"], b["jp"], js, b["jcost"],
                       JConfig(batch_size=8), mesh=jone),
        lambda: serve(b["trt"], b["tp"], ts, b["tcost"],
                      ServingConfig(batch_size=8), mesh=tone))
    for kw in (dict(batch_size=8), dict()):
        _raises_like(
            lambda: JEngine(b["jrt"], b["jp"], b["jcost"], JConfig(**kw),
                            mesh=jone),
            lambda: Engine(b["trt"], b["tp"], b["tcost"],
                           ServingConfig(**kw), mesh=tone))
    # no "data" axis; replicas above the data axis
    jx = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    tx = ServingMesh(["cpu"], ("x",))
    msg = _raises_like(
        lambda: jserve(b["jrt"], b["jp"], js, b["jcost"],
                       JConfig(path="sharded", batch_size=8), mesh=jx),
        lambda: serve(b["trt"], b["tp"], ts, b["tcost"],
                      ServingConfig(path="sharded", batch_size=8), mesh=tx))
    assert "'data' axis" in msg
    msg = _raises_like(
        lambda: jserve(b["jrt"], b["jp"], js, b["jcost"],
                       JConfig(batch_size=8, replicas=2), mesh=jone),
        lambda: serve(b["trt"], b["tp"], ts, b["tcost"],
                      ServingConfig(batch_size=8, replicas=2), mesh=tone))
    assert "exceeds data axis size 1" in msg
    # the mesh builder's own checks
    _raises_like(lambda: jmesh.make_serving_mesh(0),
                 lambda: make_serving_mesh(0, device="cpu"))


def test_model_axis_and_foreign_devices_raise(bed):
    """A "model" axis splits parameters Megatron-style (model
    parallelism, not ported); a mesh on other devices than the runtime's
    and the parameters' raises; neither falls back."""
    b = bed["elasticbert12"]
    model = ServingMesh(np.full((2, 2), "cpu", dtype=object),
                        ("data", "model"))
    with pytest.raises(NotImplementedError, match="model parallelism"):
        serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
              ServingConfig(batch_size=8, replicas=2), mesh=model)
    with pytest.raises(ValueError, match="do not match the runtime"):
        serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
              ServingConfig(batch_size=8, mesh=True),
              mesh=ServingMesh(["meta"], ("data",)))


def test_cuda_mesh_raises_on_a_cpu_only_host():
    """The mesh defaults to the card, as every entry point of the port: on
    a host without CUDA it raises rather than list CPU replicas."""
    if torch.cuda.is_available():
        pytest.skip("this process has CUDA; the guard is for CPU-only hosts")
    for kw in (dict(), dict(device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_serving_mesh(2, **kw)
    mesh = make_serving_mesh(3, device="cpu")
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)
    assert list(mesh.devices) == [torch.device("cpu")] * 3


def test_engine_refuses_the_distributed_runtime_as_reference(bed):
    """`Engine` on a distributed config raises the reference's error;
    `serve()` on it still raises "not ported yet"."""
    b = bed["elasticbert12"]
    config = dict(distributed=True)
    _raises_like(lambda: JEngine(b["jrt"], b["jp"], b["jcost"],
                                 JConfig(**config)),
                 lambda: Engine(b["trt"], b["tp"], b["tcost"],
                                ServingConfig(**config)))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        serve(b["trt"], b["tp"], _streams()[1], b["tcost"],
              ServingConfig(**config))
