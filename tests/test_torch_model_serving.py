"""Port vs reference: SplitEE served over a ("data", "model") mesh (model
parallelism in `serving/sharded.py`, `launch/mesh.py:make_model_serving_mesh`,
the exit over a vocabulary split and WKV6 on head shards).

* `serve(path="sharded", mesh=DeviceMesh)` over a (2, 2) and a (1, 2)
  gloo mesh: 4 rank subprocesses started once for the module (the (1, 2)
  meshes are the two ("data", "model") slices of a (2, 1, 2) mesh, so
  both pairs serve), on smoke weights made by the port from a seed
  (float32, passed as .npz to the ranks and to the reference, whose
  parameter tree has the same leaves). ElasticBERT-12 and rwkv6-3b in
  the sync, K = 1, fused-exit, scan-edge and SplitEE-S modes; at (1, 2)
  also an `Engine(mesh=)` push-session fed in ragged chunks, a
  `MultiTenantEngine` tenant and the distributed path of one host
  (`serve(path="distributed", mesh=)`);
  zamba2-1.2b (hybrid) and phi3.5-moe (MoE) smoke at (1, 2) in the sync
  and scan modes. Each run is held to the port's unbound run (a
  `ServingMesh` of as many CPU replicas as the mesh's "data" axis), and
  ElasticBERT-12's and rwkv6-3b's (2, 2) runs to the reference's
  `serve(mesh=)` on 4 forced host devices over a ("data", "model") mesh
  (a subprocess, after the ranks). Decisions (arms, exits, predictions,
  offload bytes, replicas, overlapped batches) exactly; rewards, the
  controller's q and the cost within ``FLOAT_ATOL`` = 1e-6 (the
  row-parallel products sum their shards in another order, which moves a
  confidence by float32 round-off; α keeps ``ALPHA_MARGIN`` from every
  confidence). Every rank reads the same whole results, bit for bit.
* In process, on threaded ranks: the exit over a vocabulary split (plain,
  fused, grouped, with a head bias) equals the whole call, and uneven
  vocabulary or row shards raise; the lockstep
  check raises on ranks that diverge; a `DeviceMesh` without a "model"
  axis serves as the data-only mesh; `make_model_serving_mesh`'s errors.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream, make_dataset
from repro_torch.launch.mesh import (make_mesh, make_model_serving_mesh,
                                     make_serving_mesh)
from repro_torch.models.api import build_model
from repro_torch.models.transformer import forward_exits
from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve
from repro_torch.serving.distributed import _free_port
from repro_torch.sharding.rules import map_with_path

from _threaded_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = 21          # 3 micro-batches of 8, the last ragged
BATCH = 8
FLOAT_ATOL = 1e-6
ALPHA_MARGIN = 1e-4
CHUNKS = (5, 1, 7, 3, 5)         # an Engine's ragged submits
# the rank and reference subprocesses compute on one thread each, at a
# lower scheduling priority (a nice increment of LOW_PRIORITY), and the
# reference starts only after the ranks have ended: the suite's other
# workers run heartbeat-timed clusters beside them
_ONE_THREAD = (" --xla_cpu_multi_thread_eigen=false"
               " intra_op_parallelism_threads=1")
LOW_PRIORITY = 10

# mode -> (ServingConfig fields, fused exit, how it is driven)
MODES = {
    "sync": (dict(overlap=False), False, "serve"),
    "K=1": (dict(overlap_depth=1), False, "serve"),
    "fused": (dict(overlap=False), True, "serve"),
    "scan": (dict(edge_mode="scan", overlap_depth=1), False, "serve"),
    "side": (dict(side_info=True, overlap=False), False, "serve"),
    "engine": (dict(overlap_depth=1), False, "engine"),
    "tenant": (dict(overlap_depth=1), False, "tenant"),
    "distributed": (dict(overlap=False), False, "distributed"),
}
REF_MODES = ("sync", "K=1", "fused", "scan", "side")
# arch -> mesh -> modes
PLAN = {
    "elasticbert12": {"2x2": REF_MODES, "1x2": tuple(MODES)},
    "rwkv6-3b": {"2x2": REF_MODES, "1x2": tuple(MODES)},
    "zamba2-1.2b": {"1x2": ("sync", "scan")},
    "phi3.5-moe-42b-a6.6b": {"1x2": ("sync", "scan")},
}
DATA = {"2x2": 2, "1x2": 1}
CASES = [(a, m, mode) for a, meshes in PLAN.items()
         for m, modes in meshes.items() for mode in modes]
KEYS = ("arms", "exited", "preds", "rewards", "q", "n", "scalars")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size calls on one intra-op thread (the rank and reference
    subprocesses and the suite's other workers share the cores); restored
    after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _config(mode, replicas):
    kw, _, how = MODES[mode]
    path = "distributed" if how == "distributed" else "sharded"
    return dict(path=path, batch_size=BATCH, replicas=replicas, **kw)


# the compared fields of a report, as arrays; the rank subprocesses run
# the same source
_RECORD = textwrap.dedent("""
    def _record(rep):
        return {"arms": np.asarray(rep.arms),
                "exited": np.asarray(rep.exited),
                "preds": np.asarray(rep.preds),
                "rewards": np.asarray(rep.rewards),
                "q": np.asarray(rep.state["q"]),
                "n": np.asarray(rep.state["n"]),
                "scalars": np.asarray([rep.cost_total, rep.offload_bytes,
                                       rep.replicas or 1,
                                       (rep.overlap or {}).get(
                                           "batches_overlapped", 0)],
                                      np.float64)}
""")
exec(_RECORD)


_RANK = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.nice(LOW_PRIORITY)
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    args = json.loads(sys.argv[1])
    rank = int(sys.argv[2])
    dist.init_process_group("gloo", rank=rank, world_size=4,
                            init_method=f"tcp://localhost:{args['port']}")
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import CostModel
    from repro_torch.data import OnlineStream, make_dataset
    from repro_torch.launch.mesh import make_model_serving_mesh
    from repro_torch.serving import (EdgeCloudRuntime, Engine,
                                     MultiTenantEngine, ServingConfig,
                                     TenantSpec, serve)
    exec(args["record"])
    meshes = {"2x2": make_model_serving_mesh(2, 2, device="cpu"),
              "1x2": DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2),
                                mesh_dim_names=("pair", "data", "model"))[
                                    "data", "model"]}

    def nest(flat):
        tree = {}
        for key in flat.files:
            *head, leaf = key.split("/")
            node = tree
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = flat[key]
        return tree

    def stream(n):
        return OnlineStream(make_dataset("imdb_like", n, seed=1), seed=0)

    out = {}
    for arch, spec in args["plan"].items():
        params = params_from_jax(nest(np.load(spec["weights"])), device="cpu")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cost = CostModel(num_layers=cfg.num_layers, alpha=spec["alpha"],
                         offload=3.0)
        for mname, modes in spec["meshes"].items():
            mesh = meshes[mname]
            for mode, (kw, fused, how) in modes.items():
                rt = EdgeCloudRuntime(cfg, device="cpu", fused_exit=fused)
                config = ServingConfig(**kw)
                if how == "engine":
                    eng = Engine(rt, params, cost, config, mesh=mesh)
                    samples, i = list(stream(args["n"])), 0
                    for c in args["chunks"]:
                        eng.submit(samples[i:i + c])
                        i += c
                    rep = eng.close()
                elif how == "tenant":
                    eng = MultiTenantEngine({"t": TenantSpec(
                        rt, params, cost, config, mesh=mesh)})
                    eng.submit("t", list(stream(args["n"])))
                    rep = eng.close()["t"]
                else:
                    rep = serve(rt, params, stream(args["n"]), cost, config,
                                mesh=mesh)
                for key, val in _record(rep).items():
                    out[f"{arch}|{mname}|{mode}|{key}"] = val
    np.savez(f"{args['out']}.{rank}.npz", **out)
    print("RANK_OK")
    dist.destroy_process_group()
""")

_REF = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.nice(LOW_PRIORITY)
    import jax, numpy as np
    from repro.configs import get_smoke_config
    from repro.core import CostModel
    from repro.data import OnlineStream, make_dataset
    from repro.serving.api import ServingConfig, serve
    from repro.serving.simulator import EdgeCloudRuntime
    assert len(jax.devices()) == 4, jax.devices()
    args = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch, spec in args["plan"].items():
        flat = np.load(spec["weights"])
        params = {}
        for key in flat.files:
            *head, leaf = key.split("/")
            node = params
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = flat[key]
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cost = CostModel(num_layers=cfg.num_layers, alpha=spec["alpha"],
                         offload=3.0)
        for mode, (kw, fused) in spec["modes"].items():
            rt = EdgeCloudRuntime(cfg, backend="ref",
                                  conf_backend="pallas_interpret",
                                  fused_exit=fused)
            rep = serve(rt, params, OnlineStream(make_dataset(
                "imdb_like", args["n"], seed=1), seed=0), cost,
                ServingConfig(**kw), mesh=mesh)
            rec = {"arms": rep.arms, "exited": rep.exited,
                   "preds": rep.preds, "rewards": rep.rewards,
                   "q": rep.state["q"], "n": rep.state["n"],
                   "scalars": [rep.cost_total, rep.offload_bytes,
                               rep.replicas,
                               rep.overlap["batches_overlapped"]]}
            for key, val in rec.items():
                out[f"{arch}|2x2|{mode}|{key}"] = np.asarray(val)
    np.savez(args["out"], **out)
    print("REF_MESH_OK")
""")


def _flat(params):
    """{"a/b/c": numpy leaf} of a parameter tree."""
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(
        "/".join(map(str, path)), leaf.detach().numpy()), params)
    return out


def _alpha(cfg, params):
    """A threshold inside the middle half of the stream's confidences, at
    their widest gap there, kept ``ALPHA_MARGIN`` from every one."""
    data = make_dataset("imdb_like", N_SAMPLES, seed=1)
    conf = np.sort(forward_exits(params, cfg, {"tokens": torch.as_tensor(
        data["tokens"])})["conf"].numpy().ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    alpha = float(conf[k] + conf[k + 1]) / 2
    assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
    return alpha


def _unbound(bed):
    """The port's own run of each case on a `ServingMesh` of as many CPU
    replicas as the mesh's "data" axis, on the same weights (the engines
    and the distributed host as the one-shot sharded run of their
    config)."""
    out, made = {}, {}
    for arch, mesh, mode in CASES:
        b = bed[arch]
        cfg = _cfg(arch)
        fused = MODES[mode][1]
        config = dict(_config(mode, DATA[mesh]), path="sharded")
        key = (arch, fused, json.dumps(config, sort_keys=True))
        if key not in made:
            made[key] = _record(serve(
                EdgeCloudRuntime(cfg, device="cpu", fused_exit=fused),
                b["params"],
                OnlineStream(make_dataset("imdb_like", N_SAMPLES, seed=1),
                             seed=0),
                CostModel(num_layers=cfg.num_layers, alpha=b["alpha"],
                          offload=3.0),
                ServingConfig(**config),
                mesh=make_serving_mesh(DATA[mesh], device="cpu")))
        out[(arch, mesh, mode)] = made[key]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Weights and α per arch; then the 4 gloo ranks start, the port's
    unbound runs are made here while they work, and the reference's
    (2, 2) run starts once they have ended. Returns (the ranks' records,
    the reference's, the unbound records)."""
    tmp = tmp_path_factory.mktemp("mesh_serving")
    bed = {}
    for arch in PLAN:
        cfg = _cfg(arch)
        params = build_model(cfg).init(seed=0, device="cpu")
        np.savez(tmp / f"{arch}.npz", **_flat(params))
        bed[arch] = dict(weights=str(tmp / f"{arch}.npz"),
                         alpha=_alpha(cfg, params), params=params)
    plan = {a: dict(weights=bed[a]["weights"], alpha=bed[a]["alpha"],
                    meshes={m: {mode: (_config(mode, DATA[m]),
                                       MODES[mode][1], MODES[mode][2])
                                for mode in modes}
                            for m, modes in PLAN[a].items()})
            for a in PLAN}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    rank_args = dict(plan=plan, n=N_SAMPLES, out=str(tmp / "rank"),
                     port=_free_port(), chunks=CHUNKS, record=_RECORD)
    rank_src = _RANK.replace("LOW_PRIORITY", str(LOW_PRIORITY))
    procs = [subprocess.Popen([sys.executable, "-c", rank_src,
                               json.dumps(rank_args), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for r in range(4)]
    ref_plan = {a: dict(weights=bed[a]["weights"], alpha=bed[a]["alpha"],
                        modes={m: (_config(m, 2), MODES[m][1])
                               for m in REF_MODES})
                for a in ("elasticbert12", "rwkv6-3b")}
    ref_env = dict(env, JAX_PLATFORMS="cpu")
    ref_env["XLA_FLAGS"] = (ref_env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=4"
                            + _ONE_THREAD).strip()
    try:
        unbound = _unbound(bed)
        outs = [p.communicate(timeout=600) for p in procs]
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             _REF.replace("LOW_PRIORITY", str(LOW_PRIORITY)),
             json.dumps(dict(plan=ref_plan, n=N_SAMPLES,
                             out=str(tmp / "ref.npz")))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=ref_env, cwd=ROOT))
        outs.append(procs[-1].communicate(timeout=600))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(err[-3000:] for _, err in outs)
    assert all("RANK_OK" in o for o, _ in outs[:4])
    assert "REF_MESH_OK" in outs[4][0]
    ranks = [dict(np.load(tmp / f"rank.{r}.npz")) for r in range(4)]
    return ranks, dict(np.load(tmp / "ref.npz")), unbound


def _assert_close(got, want, what):
    for key in ("arms", "exited", "preds", "n"):
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{what} {key}")
    for key in ("rewards", "q"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=FLOAT_ATOL, err_msg=f"{what} {key}")
    cost, nbytes, replicas, overlapped = got["scalars"]
    assert abs(cost - want["scalars"][0]) <= 10 * FLOAT_ATOL, what
    assert (nbytes, replicas, overlapped) == tuple(want["scalars"][1:]), what


@pytest.mark.parametrize("arch,mesh,mode", CASES)
def test_mesh_serving_matches_the_unbound_run(runs, arch, mesh, mode):
    ranks, _, unbound = runs
    got = {k: ranks[0][f"{arch}|{mesh}|{mode}|{k}"] for k in KEYS}
    _assert_close(got, unbound[(arch, mesh, mode)], f"{arch} {mesh} {mode}")


@pytest.mark.parametrize("arch", ["elasticbert12", "rwkv6-3b"])
@pytest.mark.parametrize("mode", REF_MODES)
def test_mesh_serving_matches_the_reference_mesh_run(runs, arch, mode):
    """The (2, 2) run against the reference's `serve(mesh=)` over a
    (2, 2) ("data", "model") mesh of forced host devices."""
    ranks, ref, _ = runs
    prefix = f"{arch}|2x2|{mode}"
    got = {k: ranks[0][f"{prefix}|{k}"] for k in KEYS}
    _assert_close(got, {k: ref[f"{prefix}|{k}"] for k in KEYS}, prefix)


def test_every_rank_reads_the_same_results(runs):
    """SPMD: every rank of a mesh reads whole confidences, so its
    controller, predictions and accounting are the same bits as rank
    0's (both (1, 2) pairs included)."""
    ranks = runs[0]
    for r in range(1, 4):
        assert sorted(ranks[r]) == sorted(ranks[0])
        for key, val in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][key], val, err_msg=key)


def test_engine_and_tenant_sessions_equal_the_one_shot_run(runs):
    """An `Engine(mesh=)` fed in ragged chunks and a `MultiTenantEngine`
    tenant over the mesh are the one-shot K = 1 `serve(mesh=)` bit for
    bit; one distributed host over the mesh is the sharded sync run."""
    ranks = runs[0]
    for arch in ("elasticbert12", "rwkv6-3b"):
        for mesh, modes in PLAN[arch].items():
            for mode, same in (("engine", "K=1"), ("tenant", "K=1"),
                               ("distributed", "sync")):
                if mode not in modes:
                    continue
                for key in KEYS:
                    np.testing.assert_array_equal(
                        ranks[0][f"{arch}|{mesh}|{mode}|{key}"],
                        ranks[0][f"{arch}|{mesh}|{same}|{key}"],
                        err_msg=f"{arch} {mesh} {mode} {key}")


# ---------------------------------------------------- threaded-rank units

def test_exit_on_a_vocabulary_split_equals_the_whole_call():
    """On a (2, 2) mesh of threaded ranks: rows over "data", the head (and
    its bias) over "model" on V = 13 (not divisible: the head stays
    whole) and V = 12; plain, grouped and fused (per-row norm parameters
    placed as the rows). Confidences within 1e-6, predictions equal;
    results placed as the rows."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.exit_confidence.ops import (
        exit_confidence, exit_confidence_fused)
    g = torch.Generator().manual_seed(0)
    h = torch.randn(8, 16, generator=g)
    hg = torch.randn(3, 8, 16, generator=g)
    scale = 1.0 + 0.1 * torch.randn(8, 16, generator=g)
    shift = 0.1 * torch.randn(16, generator=g)
    heads = {v: (torch.randn(16, v, generator=g), torch.randn(v, generator=g),
                 torch.randn(3, 16, v, generator=g)) for v in (12, 13)}
    want = {v: (exit_confidence(h, w, b), exit_confidence(hg, wg),
                exit_confidence_fused(h, {"scale": scale, "bias": shift}, w,
                                      b, kind="layernorm"))
            for v, (w, b, wg) in heads.items()}

    def rank(_):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        rows, split = [Shard(0), Replicate()], [Replicate(), Shard(1)]
        out = {}
        for v, (w, b, wg) in heads.items():
            vs = split if v % 2 == 0 else [Replicate(), Replicate()]
            hd = distribute_tensor(h, mesh, rows)
            wd, bd = (distribute_tensor(w, mesh, vs),
                      distribute_tensor(b, mesh, [vs[0], Shard(0)]
                                        if v % 2 == 0 else vs))
            plain = exit_confidence(hd, wd, bd)
            assert plain[0].placements == tuple(rows)
            grouped = exit_confidence(
                distribute_tensor(hg, mesh, [Shard(1), Replicate()]),
                distribute_tensor(wg, mesh, [Replicate(),
                                             Shard(2) if v % 2 == 0
                                             else Replicate()]))
            fused = exit_confidence_fused(
                hd, {"scale": distribute_tensor(scale, mesh, rows),
                     "bias": shift}, wd, bd, kind="layernorm")
            out[v] = tuple(tuple(t.full_tensor() for t in pair)
                           for pair in (plain, grouped, fused))
        return out

    for out in run_ranks(rank, 4).values():
        for v in heads:
            for (c, p), (wc, wp) in zip(out[v], want[v]):
                torch.testing.assert_close(c, wc, rtol=1e-6, atol=1e-7)
                assert torch.equal(p, wp)


@pytest.mark.parametrize("uneven", ["vocabulary", "rows"])
def test_exit_on_uneven_shards_raises(uneven):
    """Every rank's triples are gathered as blocks of one size: a
    vocabulary (V = 13) or rows (B = 7) split unevenly over a mesh axis
    raise `ValueError` on every rank, before any collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    g = torch.Generator().manual_seed(0)
    rows, v = (8, 13) if uneven == "vocabulary" else (7, 12)
    h = torch.randn(rows, 16, generator=g)
    w = torch.randn(16, v, generator=g)

    def rank(_):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        try:
            exit_confidence(
                distribute_tensor(h, mesh, [Shard(0), Replicate()]),
                distribute_tensor(w, mesh, [Replicate(), Shard(1)]))
        except ValueError as e:
            return str(e)
        return None

    for msg in run_ranks(rank, 4).values():
        assert msg is not None and f"{uneven} of" in msg and "unevenly" in msg


def test_lockstep_check_raises_when_ranks_diverge():
    """`_check_lockstep` passes ranks that agree and raises, on every
    rank, when one rank's arms differ."""
    from repro_torch.serving.sharded import _check_lockstep
    cost = CostModel(num_layers=4, alpha=0.5, offload=3.0)
    conf = [np.asarray([0.9]), np.asarray([0.1])]

    def rank(r):
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        _check_lockstep(mesh, np.asarray([0, 2]), conf, cost)
        try:
            _check_lockstep(mesh, np.asarray([0, 2 + r]), conf, cost)
        except RuntimeError as e:
            return str(e)
        return None

    for msg in run_ranks(rank, 2).values():
        assert msg is not None and "diverged" in msg


def test_a_device_mesh_without_a_model_axis_serves_as_the_data_mesh():
    """A one-rank ("data",) `DeviceMesh` (every leaf replicated, the
    exit's partials and combine over one shard) makes the decisions of
    the 1-D `ServingMesh`, and its floats within f32 round-off."""
    cfg = _cfg("elasticbert12")
    params = build_model(cfg).init(seed=0, device="cpu")
    cost = CostModel(num_layers=cfg.num_layers, alpha=0.5, offload=3.0)
    rt = EdgeCloudRuntime(cfg, device="cpu")
    config = ServingConfig(path="sharded", batch_size=BATCH, overlap=False)

    def stream():
        return OnlineStream(make_dataset("imdb_like", 16, seed=1), seed=0)

    want = _record(serve(rt, params, stream(), cost, config))
    got = run_ranks(lambda _: _record(serve(
        rt, params, stream(), cost, config,
        mesh=make_mesh((1,), ("data",), device="cpu"))), 1)[0]
    _assert_close(got, want, "('data',) DeviceMesh")


def test_make_model_serving_mesh_errors():
    """It starts no process group and needs one of data x model ranks;
    on a host without CUDA the default device raises (no CPU fallback)."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="process group"):
        make_model_serving_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_model_serving_mesh(0, 2, device="cpu")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model_serving_mesh(1, 2)

    def rank(_):
        with pytest.raises(ValueError, match="world of 4"):
            make_model_serving_mesh(2, 2, device="cpu")
        mesh = make_model_serving_mesh(1, 2, device="cpu")
        return mesh.mesh_dim_names, tuple(mesh.shape)
    assert run_ranks(rank, 2)[0] == (("data", "model"), (1, 2))
