"""Port vs reference: the multi-pod dry run (`repro_torch.launch.dryrun`)
and the config and model surface it reads.

* `Model.input_specs` and `Model.abstract_params` give meta tensors whose
  paths, shapes and dtypes equal the reference's ``ShapeDtypeStruct``s,
  leaf for leaf, for every arch in ``ASSIGNED_ARCHS`` x ``INPUT_SHAPES``
  (the twin of ``test_dryrun_unit.py``'s 40-combo check); the config
  surface (``INPUT_SHAPES``, ``get_input_shape``, ``list_archs``,
  ``active_param_count``) equals the reference's; `_with_depth` scales
  the encoder too.
* `build_step`'s parameter, optimizer, batch and cache placements equal
  the reference's ``build_step`` shardings spec for spec on the
  production (16, 16) mesh, every combo, and on the (2, 16, 16) two-pod
  mesh for two: the reference in a subprocess over 512 forced host
  devices, the port over a fake 256/512-rank process group. By design
  the port has no ``count`` leaf in its optimizer state (a Python int)
  and passes ``cur_index`` as an int: the test names both.
* One smoke combo (qwen3-1.7b's smoke config, train_4k's shape) on a
  (2, 4) ("data", "model") mesh: the port's per-device
  ``argument_bytes`` equals the reference's
  ``compiled.memory_analysis().argument_size_in_bytes`` for the
  reference's own ``build_step``, less the 4 bytes of the reference's
  int32 step count; the port's per-device matmul flops are within
  ``FLOP_RTOL`` (1 %) of the reference's ``parse_dot_flops`` of the
  compiled step with its layer scan unrolled (``LAYER_SCAN_UNROLL``).
  One difference is larger and named: ``DTensor``'s strategy for the
  input gradient of an MLP's row-parallel product (``h @ wo``) can run it
  against the whole ``wo`` (all-gathered over "model") where GSPMD keeps
  the inner dim split; the test counts those products' flops and takes
  the part a split inner dim would not do (1 - 1/model) off the port's
  count before the 1 % comparison.
* Flops are counted per device, at each op's local shapes: a product
  whose weight is replicated over "model" counts the same on each rank
  of the model axis (global / data, not global / world).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                 get_config as t_get_config,
                                 get_input_shape, list_archs)
from repro_torch.launch import dryrun as tdry
from repro_torch.models.api import build_model as t_build_model
from repro_torch.sharding.rules import map_with_path

import jax

from repro.configs import (get_config, get_input_shape as j_get_input_shape,
                           list_archs as j_list_archs)
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.models.api import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's subprocess computes on one thread: the suite's other
# workers run timing-bound clusters beside it
_ONE_THREAD = (" --xla_cpu_multi_thread_eigen=false"
               " intra_op_parallelism_threads=1")
FLOP_RTOL = 0.01
SMOKE_ARCH, SMOKE_SHAPE, SMOKE_MESH = "qwen3-1.7b", "train_4k", (2, 4)
MULTIPOD = [("qwen3-1.7b", "train_4k"), ("mixtral-8x22b", "decode_32k")]


def _dtype_name(x):
    return (str(x.dtype).split(".")[1] if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)


def _ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(
        "/".join(str(k) for k in path), leaf), tree)
    return out


def _assert_same_leaves(got, want, what):
    g, w = _port_leaves(got), _ref_leaves(want)
    assert sorted(g) == sorted(w), what
    for path in g:
        assert tuple(g[path].shape) == tuple(w[path].shape), (what, path)
        assert _dtype_name(g[path]) == _dtype_name(w[path]), (what, path)
        assert g[path].device.type == "meta", (what, path)


# ---------------------------------------------------------- config surface

def test_config_surface_matches_reference():
    assert list_archs() == j_list_archs()
    assert ASSIGNED_ARCHS == [a for a in j_list_archs()
                              if a != "elasticbert12"]
    for name, shape in J_INPUT_SHAPES.items():
        assert INPUT_SHAPES[name] == get_input_shape(name)
        got = INPUT_SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (shape.name, shape.seq_len, shape.global_batch, shape.kind)
        assert j_get_input_shape(name) == shape
    with pytest.raises(KeyError, match="unknown input shape"):
        get_input_shape("train_1m")
    for arch in j_list_archs():
        assert t_get_config(arch).active_param_count() == \
            get_config(arch).active_param_count(), arch


def test_with_depth_scales_encoder_too():
    r = tdry._with_depth(t_get_config("seamless-m4t-large-v2"), 2)
    assert r.num_layers == 2 and r.encoder.num_layers == 2
    r = tdry._with_depth(t_get_config("qwen3-1.7b"), 3)
    assert r.num_layers == 3 and r.encoder is None


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_and_abstract_params_match_reference(arch):
    """Every shape's input specs and the parameter tree, leaf for leaf,
    as meta tensors (nothing allocated)."""
    jm, tm = build_model(get_config(arch)), t_build_model(t_get_config(arch))
    _assert_same_leaves(tm.abstract_params(), jm.abstract_params(),
                        f"{arch} params")
    for name, shape in J_INPUT_SHAPES.items():
        _assert_same_leaves(tm.input_specs(INPUT_SHAPES[name]),
                            jm.input_specs(shape), f"{arch} x {name}")


# ----------------------------------------------------- shardings per combo

_REF_SPECS = textwrap.dedent("""
    import json, sys
    import jax
    from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
    from repro.launch.dryrun import build_step
    from repro.launch.mesh import make_production_mesh
    args = json.loads(sys.argv[1])

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): [list(a) if isinstance(a, tuple) else a
                                          for a in leaf.spec]
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    for multi_pod, combos in ((False, [(a, s) for a in ASSIGNED_ARCHS
                                       for s in INPUT_SHAPES]),
                              (True, args["multipod"])):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for a, s in combos:
            fn, fargs, in_sh, cfg, shape = build_step(a, s, mesh, multi_pod)
            out[f"{a}|{s}|{multi_pod}"] = [flat(t) for t in in_sh]
    json.dump(out, open(args["out"], "w"))
    print("REF_SPECS_OK")
""")


def _run(script, args, devices, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={devices}"
                        + _ONE_THREAD).strip()
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(args)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.json"
    stdout = _run(_REF_SPECS, dict(out=str(out), multipod=MULTIPOD), 512)
    assert "REF_SPECS_OK" in stdout
    return json.loads(out.read_text())


def _spec_json(spec):
    """A spec as the reference's JSON gives it (``PartitionSpec`` keeps a
    one-axis tuple as the bare axis name)."""
    return [(a[0] if len(a) == 1 else list(a)) if isinstance(a, tuple)
            else a for a in spec]


def _port_specs(arch, shape_name, multi_pod):
    """The port's `build_step` shardings as {path: spec} per argument,
    over a fake world of the production mesh's size."""
    world = 512 if multi_pod else 256
    with tdry.fake_world(world):
        mesh = tdry.make_production_mesh(multi_pod=multi_pod, device="cpu")
        _, _, in_sh, _, _ = tdry.build_step(arch, shape_name, mesh,
                                            multi_pod)
        return [{k: _spec_json(v.spec) for k, v in _port_leaves(t).items()}
                for t in in_sh]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shardings_match_reference_on_production_mesh(ref_specs, arch):
    combos = [(s, False) for s in INPUT_SHAPES] + \
        [(s, True) for a, s in MULTIPOD if a == arch]
    for shape_name, multi_pod in combos:
        want = ref_specs[f"{arch}|{shape_name}|{multi_pod}"]
        got = _port_specs(arch, shape_name, multi_pod)
        what = f"{arch} x {shape_name} multi_pod={multi_pod}"
        assert got[0] == want[0], what                         # params
        if INPUT_SHAPES[shape_name].kind == "train":
            # the reference's optimizer tree {"count", "m", "v"}: the
            # moments placed as their parameters; "count" (an int32
            # scalar, replicated) is a Python int in the port
            assert want[1].pop("count") == []
            for mom in ("m", "v"):
                assert {k.replace(".", "/"): v for k, v in
                        got[1].items() if k.startswith(mom + "/")} == \
                    {k: v for k, v in want[1].items()
                     if k.startswith(mom + "/")}, (what, mom)
            assert got[2] == want[2], what                     # batch
        elif INPUT_SHAPES[shape_name].kind == "prefill":
            assert got[1] == want[1], what
        else:
            # reference: (params, caches, token, cur_index[, extras]);
            # the port passes cur_index as an int (replicated there)
            assert want.pop(3) == {"": []}, what
            assert got[1:] == want[1:], what


# --------------------------------------- per-device bytes and flops, smoke

_REF_SMOKE = textwrap.dedent("""
    import json, sys, dataclasses
    import jax
    from repro.configs import get_smoke_config
    from repro.launch import dryrun as D
    from repro.launch.mesh import axis_map
    from repro.models import transformer as tf
    from repro.sharding.rules import mesh_rules
    args = json.loads(sys.argv[1])
    cfg = get_smoke_config(args["arch"])
    mesh = jax.make_mesh(tuple(args["mesh"]), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tf.LAYER_SCAN_UNROLL = cfg.num_layers
    fn, fargs, in_sh, cfg, shape = D.build_step(args["arch"], args["shape"],
                                                mesh, False, cfg=cfg)
    with mesh_rules(mesh, axis_map(False)):
        compiled = jax.jit(fn, in_shardings=in_sh).lower(*fargs).compile()
    mem = compiled.memory_analysis()
    print(json.dumps({"argument_bytes": int(mem.argument_size_in_bytes),
                      "dot_flops": D.parse_dot_flops(compiled.as_text())}))
""")


class _ByOpCounter(tdry.StepCounter):
    """`StepCounter` that also keeps each product's flops by operand
    shapes."""

    def __init__(self):
        super().__init__()
        self.by_shapes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and self.flops != before:
            key = tuple(tuple(a.shape) for a in args
                        if isinstance(a, torch.Tensor))
            self.by_shapes[key] = self.by_shapes.get(key, 0) + \
                self.flops - before
        return out


@pytest.fixture(scope="module")
def smoke_combo(monkeypatch_module):
    """(reference, port, port's flops by operand shapes, cfg) of the
    smoke combo."""
    stdout = _run(_REF_SMOKE, dict(arch=SMOKE_ARCH, shape=SMOKE_SHAPE,
                                   mesh=list(SMOKE_MESH)), 8)
    ref = json.loads(stdout.strip().splitlines()[-1])
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from torch._subclasses.fake_tensor import FakeTensorMode
    counters = []

    def counter():
        counters.append(_ByOpCounter())
        return counters[-1]
    monkeypatch_module.setattr(tdry, "StepCounter", counter)
    cfg = get_smoke_config(SMOKE_ARCH)
    with tdry.fake_world(int(np.prod(SMOKE_MESH))):
        mesh = make_mesh(SMOKE_MESH, ("data", "model"), device="cpu")
        with FakeTensorMode():
            fn, args, in_sh, cfg, shape = tdry.build_step(
                SMOKE_ARCH, SMOKE_SHAPE, mesh, False, cfg=cfg)
            arg_bytes, _, _, terms = tdry.run_step(mesh, False, fn, args,
                                                   in_sh, train=True)
    return ref, {"argument_bytes": arg_bytes, **terms}, \
        counters[-1].by_shapes, cfg


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_smoke_argument_bytes_equal_reference(smoke_combo):
    ref, port, _, _ = smoke_combo
    count_bytes = 4          # the reference's int32 step count, replicated
    assert port["argument_bytes"] + count_bytes == ref["argument_bytes"]


def test_smoke_dot_flops_within_one_percent_of_reference(smoke_combo):
    ref, port, by_shapes, cfg = smoke_combo
    model = SMOKE_MESH[1]
    # products against a whole (D, F) wo transpose: the MLP's input
    # gradient run with its inner dim gathered (see the module docstring)
    whole = sum(f for shapes, f in by_shapes.items()
                if len(shapes) == 2 and shapes[1] == (cfg.d_model,
                                                      cfg.d_ff))
    excess = whole * (model - 1) // model
    got = port["flops"] - excess
    assert abs(got - ref["dot_flops"]) <= FLOP_RTOL * ref["dot_flops"], \
        (port["flops"], excess, ref["dot_flops"])


def test_flops_are_counted_per_device_not_globally():
    """(8, 64, 32) @ (32, 16) on a (2, 4) mesh: with the weight split over
    "model" each rank does 1/8 of the product; replicated over "model"
    each does 1/2 (its data shard), which a global count / world misses."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    total = 2 * 8 * 64 * 32 * 16
    with tdry.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 64, 32), mesh,
                                  [Shard(0), Replicate()])
            for w_pl, want in (([Replicate(), Shard(1)], total // 8),
                               ([Replicate(), Replicate()], total // 2)):
                w = distribute_tensor(torch.empty(32, 16), mesh, w_pl)
                counter = tdry.StepCounter()
                with tdry.marked_propagation(), counter:
                    x @ w
                assert counter.flops == want, (w_pl, counter.flops)
