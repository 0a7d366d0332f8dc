"""Port vs reference: model parallelism (logical-axis constraints, the
production mesh, Megatron tensor parallelism and sequence parallelism
over ``DTensor``, the model-parallel train step).

* `constrain` is the identity when no mesh is bound, and on a plain
  tensor under a bound mesh; `make_production_mesh` keeps the reference's
  ``dp * tp == 256`` assertion and starts no process group.
* ``train_loss(seq_parallel=True/False)`` and its gradients over a (2, 2)
  ("data", "model") CPU mesh of 4 gloo ranks (subprocesses) equal the
  reference's ``train_loss`` under ``mesh_rules`` on 4 forced host
  devices (a subprocess), on the same weights passed as .npz: a smoke
  dense config (qwen3-1.7b: GQA, qk_norm) and a smoke MoE config
  (mixtral-8x22b: 4 experts, top-2), float32; loss at rtol = atol =
  1e-5, gradients at rtol = atol = 1e-4 (``LOSS_TOL``, ``GRAD_TOL``).
  The same ranks run one model-parallel train step, held to the
  unbound step on whole tensors (updated parameters and the global
  gradient norm, ``STEP_TOL``).
* Unbound, the loss and its gradients are bitwise the same with
  ``seq_parallel`` on or off, and under a bound mesh on plain tensors.
* The attention wrapper runs ``DTensor`` inputs on their local head
  shards and refuses a split head.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models.api import build_model
from repro_torch.serving.distributed import _free_port
from repro_torch.sharding import rules as trules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's subprocess computes on one thread: the suite's other
# workers run timing-bound clusters beside it
_ONE_THREAD = (" --xla_cpu_multi_thread_eigen=false"
               " intra_op_parallelism_threads=1")
ARCHS = ["qwen3-1.7b", "mixtral-8x22b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size calls on one intra-op thread (the suite runs parallel
    workers); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch):
    import dataclasses
    return dataclasses.replace(t_get_smoke_config(arch), dtype="float32")


# ------------------------------------------------------------ unit checks

def test_constrain_is_identity_unbound_and_on_plain_tensors():
    x = torch.randn(4, 6, 8)
    assert trules.current_mesh() is None
    assert trules.constrain(x, "batch", None, "model") is x
    assert trules.logical_to_spec("batch", None) == (None, None)
    assert trules.logical_size("model") == 1
    mesh = tmesh.ServingMesh(np.full((1, 1), "cpu", dtype=object),
                             ("data", "model"))
    with trules.mesh_rules(mesh, tmesh.AXIS_MAP_SINGLE):
        assert trules.current_mesh() is mesh
        assert trules.logical_to_spec("batch", None, "model") == \
            (("data",), None, "model")
        assert trules.constrain(x, "batch", None, "model") is x
    assert trules.current_mesh() is None


def test_production_mesh_checks_and_starts_no_process_group():
    import torch.distributed as dist
    with pytest.raises(AssertionError):
        tmesh.make_production_mesh(dp=10, tp=10)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device="cpu")
    assert tmesh.axis_map(True) == {"batch": ("pod", "data"),
                                    "model": "model", "seq": None}
    assert tmesh.batch_axes(False) == ("data",)


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ["elasticbert12", "qwen3-1.7b",
                                  "mixtral-8x22b", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_unbound_loss_is_bitwise_unchanged(arch):
    """Unbound, every constraint is the identity: the loss and its
    gradients are the same bits with ``seq_parallel`` on and off, and
    under a bound mesh on plain tensors."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    if cfg.num_classes:
        batch["labels"] = batch["labels"][:, 0] % cfg.num_classes

    def run(**kw):
        params = model.init(seed=0, device="cpu").requires_grad_(True)
        loss = model.train_loss(params, batch, remat=True, **kw)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in
                               params.named_parameters() if p.grad is not None}

    want_loss, want_grads = run()
    mesh = tmesh.ServingMesh(np.full((1, 1), "cpu", dtype=object),
                             ("data", "model"))
    runs = [run(seq_parallel=False)]
    with trules.mesh_rules(mesh, tmesh.AXIS_MAP_SINGLE):
        runs.append(run(seq_parallel=True))
    for loss, grads in runs:
        assert torch.equal(loss, want_loss)
        assert grads.keys() == want_grads.keys()
        for name, g in grads.items():
            assert torch.equal(g, want_grads[name]), name


# ------------------------------------------------- (2, 2) mesh vs reference

_REF = textwrap.dedent("""
    import json, sys, dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.launch.mesh import AXIS_MAP_SINGLE
    from repro.launch.shardings import batch_shardings, param_shardings
    from repro.models import transformer as tf
    from repro.sharding.rules import mesh_rules, _path_str
    args = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in args["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = tf.init_params(cfg, jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{arch}|param|{_path_str(path)}"] = np.asarray(leaf)
        rng = np.random.default_rng(7)
        b, s = args["b"], args["s"]
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
        for k, v in batch.items():
            out[f"{arch}|batch|{k}"] = v
        p_sh = param_shardings(mesh, params)
        b_sh = batch_shardings(mesh, batch, False)
        for sp in (True, False):
            fn = jax.jit(jax.value_and_grad(
                lambda p, bt: tf.train_loss(p, cfg, bt, remat=True,
                                            seq_parallel=sp)),
                in_shardings=(p_sh, b_sh))
            with mesh_rules(mesh, AXIS_MAP_SINGLE):
                loss, grads = fn(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
            out[f"{arch}|{sp}|loss"] = np.asarray(loss)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"{arch}|{sp}|grad|{_path_str(path)}"] = np.asarray(leaf)
    np.savez(args["out"], **out)
    print("REF_MP_OK")
""")

_WORKER = textwrap.dedent("""
    import json, sys, dataclasses
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    args = json.loads(sys.argv[1])
    rank = int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args['port']}",
                            rank=rank, world_size=4)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import AXIS_MAP_SINGLE, make_mesh
    from repro_torch.launch.shardings import (batch_shardings,
                                              distribute_tree, param_shardings)
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParamTree
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.rules import mesh_rules
    ref = np.load(args["ref"])
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}

    def nest(prefix):
        tree = {}
        for key in ref.files:
            if key.startswith(prefix):
                node = tree
                *parents, leaf = key[len(prefix):].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = torch.from_numpy(ref[key].copy())
        return tree

    def whole(tree):
        return {n: p.full_tensor() for n, p in tree.named_parameters()}

    for arch in args["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = build_model(cfg)
        plain = nest(f"{arch}|param|")
        batch = {k: torch.from_numpy(ref[f"{arch}|batch|{k}"])
                 for k in ("tokens", "labels")}
        sh = param_shardings(mesh, plain)
        dbatch = distribute_tree(mesh, batch, batch_shardings(mesh, batch, False))
        for sp in (True, False):
            params = ParamTree(distribute_tree(mesh, plain, sh)).requires_grad_(True)
            with mesh_rules(mesh, AXIS_MAP_SINGLE):
                loss = model.train_loss(params, dbatch, remat=True,
                                        seq_parallel=sp)
                loss.backward()
            out[f"{arch}|{sp}|loss"] = loss.full_tensor().detach().numpy()
            for n, p in params.named_parameters():
                g = p.grad.full_tensor() if p.grad is not None \\
                    else torch.zeros(p.shape)
                out[f"{arch}|{sp}|grad|{n.replace('.', '/')}"] = g.numpy()
        # one model-parallel train step
        step = make_train_step(model, AdamWConfig(), remat=True)
        params = ParamTree(distribute_tree(mesh, plain, sh)).requires_grad_(True)
        with mesh_rules(mesh, AXIS_MAP_SINGLE):
            params, _, info = step(params, adamw_init(params), dbatch)
        out[f"{arch}|step|gnorm"] = info["gnorm"].numpy()
        out[f"{arch}|step|loss"] = info["loss"].numpy()
        for n, p in whole(params).items():
            out[f"{arch}|step|param|{n.replace('.', '/')}"] = p.detach().numpy()
    if rank == 0:
        np.savez(args["out"], **out)
        print("PORT_MP_OK")
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def mp_runs(tmp_path_factory):
    """The reference's (2, 2) run (one subprocess over 4 forced host
    devices), then the port's over 4 gloo ranks (4 subprocesses) on the
    reference's weights and batches. Returns (reference, port) npz."""
    tmp = tmp_path_factory.mktemp("mp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4"
                        + _ONE_THREAD).strip()
    args = dict(archs=ARCHS, b=B, s=S, out=str(tmp / "ref.npz"))
    proc = subprocess.run([sys.executable, "-c", _REF, json.dumps(args)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0 and "REF_MP_OK" in proc.stdout, \
        proc.stderr[-4000:]
    args = dict(archs=ARCHS, ref=str(tmp / "ref.npz"),
                out=str(tmp / "port.npz"), port=_free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER,
                               json.dumps(args), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(err[-3000:] for _, err in outs)
    assert "PORT_MP_OK" in outs[0][0]
    return np.load(tmp / "ref.npz"), np.load(tmp / "port.npz")


@pytest.mark.parametrize("seq_parallel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_loss_and_grads_match_reference(mp_runs, arch,
                                                        seq_parallel):
    ref, port = mp_runs
    key = f"{arch}|{seq_parallel}"
    np.testing.assert_allclose(port[f"{key}|loss"], ref[f"{key}|loss"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    grads = sorted(k for k in ref.files if k.startswith(f"{key}|grad|"))
    assert grads == sorted(k for k in port.files
                           if k.startswith(f"{key}|grad|"))
    for k in grads:
        np.testing.assert_allclose(port[k], ref[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_train_step_matches_unbound_step(mp_runs, arch):
    """AdamW on each rank's shards with the global gradient norm equals
    the unbound step on whole tensors (the default lr 3e-4: AdamW's first
    step moves a weight by lr·g/(|g| + eps), so where g is near 0 the
    gradients' float32 round-off moves it by up to lr, 3e-4 here, times
    their relative difference)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import ParamTree
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    ref, port = mp_runs
    tree = {}
    for key in ref.files:
        if key.startswith(f"{arch}|param|"):
            node = tree
            *parents, leaf = key.split("|")[2].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(ref[key].copy())
    model = build_model(_cfg(arch))
    params = ParamTree(tree).requires_grad_(True)
    batch = {k: torch.from_numpy(ref[f"{arch}|batch|{k}"])
             for k in ("tokens", "labels")}
    step = make_train_step(model, AdamWConfig(), remat=True)
    params, _, info = step(params, adamw_init(params), batch)
    np.testing.assert_allclose(port[f"{arch}|step|loss"], info["loss"],
                               rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(port[f"{arch}|step|gnorm"], info["gnorm"],
                               rtol=STEP_TOL, atol=STEP_TOL)
    for n, p in params.named_parameters():
        np.testing.assert_allclose(
            port[f"{arch}|step|param|{n.replace('.', '/')}"],
            p.detach().numpy(), rtol=STEP_TOL, atol=STEP_TOL, err_msg=n)


# ------------------------------------------------------ attention wrapper

def test_attention_runs_local_head_shards_and_refuses_split_heads():
    """On a 1-rank fake mesh: Shard on the head axis runs the plain
    version on the local shard (== the whole call); a split head_dim
    raises."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.kernels.flash_attention.ops import attention
    from torch.distributed.tensor import DTensor, Shard
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 6, 8, generator=g) for _ in range(3))
    with fake_world(1):
        mesh = tmesh.make_mesh((1,), ("model",), device="cpu")
        dq, dk, dv = (DTensor.from_local(t, mesh, [Shard(1)]) for t in
                      (q, k, v))
        out = attention(dq, dk, dv, causal=True, window=0)
        assert isinstance(out, DTensor) and out.placements == (Shard(1),)
        torch.testing.assert_close(out.to_local(),
                                   attention(q, k, v, causal=True, window=0),
                                   rtol=0, atol=0)
        split = [DTensor.from_local(t, mesh, [Shard(3)]) for t in (q, k, v)]
        with pytest.raises(ValueError, match="whole heads"):
            attention(*split, causal=True, window=0)


@pytest.mark.parametrize("window_split", [False, True])
@pytest.mark.parametrize("s,w,start", [(4, 4, 0), (3, 5, 0), (3, 5, 4),
                                       (5, 5, 7)])
def test_dtensor_cache_fill_and_decode_match_plain(s, w, start,
                                                   window_split):
    """The cache writes (`fill_cache`'s ring rotation, `_write_slot`) and
    the one-token attention (`decode_attention`) on ``DTensor``s equal
    the same functions on plain tensors, on a 1-rank fake mesh (ring wrap
    and a partly empty window included), replicated or with the window
    axis split (`decode_attention`'s all-reduced softmax)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import attention as tattn
    g = torch.Generator().manual_seed(s * 10 + start)
    b, hkv, hd = 2, 2, 4
    k, v = (torch.randn(b, s, hkv, hd, generator=g) for _ in range(2))
    want = tattn.fill_cache(tattn.init_cache(b, w, hkv, hd, torch.float32),
                            k, v, start=start)
    with fake_world(1):
        mesh = tmesh.make_mesh((1,), ("model",), device="cpu")

        def dt(t):
            return DTensor.from_local(t, mesh, [
                Shard(1) if window_split and t.ndim > 1 and t.shape[1] == w
                else Replicate()])
        got = tattn.fill_cache(
            {n: dt(t) for n, t in
             tattn.init_cache(b, w, hkv, hd, torch.float32).items()},
            DTensor.from_local(k, mesh, [Replicate()]),
            DTensor.from_local(v, mesh, [Replicate()]), start=start)
        for name in want:
            assert torch.equal(got[name].to_local(), want[name]), name
        slot, row = (start + s) % w, torch.randn(b, 1, hkv, hd, generator=g)
        plain = want["k"].clone()
        plain[:, slot] = row[:, 0]
        assert torch.equal(tattn._write_slot(
            dt(want["k"]), slot, dt(row)).to_local(), plain)
        assert torch.equal(tattn._write_slot(want["k"], slot, row), plain)
        q = torch.randn(b, 1, 2 * hkv, hd, generator=g)
        valid = want["pos"] >= 0
        out = tattn.decode_attention(dt(q), dt(want["k"]), dt(want["v"]),
                                     dt(valid)).to_local()
        qg = q.reshape(b, hkv, 2, hd)
        sc = torch.einsum("bngd,bwnd->bngw", qg, want["k"]) * hd ** -0.5
        sc = sc.masked_fill(~valid[:, None, None, :], -1e30)
        ref = torch.einsum("bngw,bwnd->bngd", torch.softmax(sc, -1),
                           want["v"]).reshape(b, 1, -1)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
        assert torch.equal(tattn.decode_attention(q, want["k"], want["v"],
                                                  valid), ref)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b",
                                  "seamless-m4t-large-v2"])
def test_named_shardings_match_reference(arch):
    """`named_shardings`' specs, leaf for leaf, against the reference's on
    a one-device ("data", "model") mesh (unsanitized, as it is)."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models.api import build_model as j_build_model
    from repro.sharding import rules as jrules
    abstract = j_build_model(get_smoke_config(arch)).abstract_params()
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    want = {jrules._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jrules.named_shardings(jm, abstract))[0]}
    mesh = tmesh.ServingMesh(np.full((1, 1), "cpu", dtype=object),
                             ("data", "model"))
    got = {}
    trules.map_with_path(lambda path, ns: got.__setitem__(
        "/".join(path), ns.spec), trules.named_shardings(
            mesh, build_model(_cfg(arch)).abstract_params()))
    assert got == want
