"""Port vs reference: checkpoint/store.py.

* a round trip of a `ParamTree` and of a nested dict with float32,
  bfloat16 and integer leaves (bitwise, the kind of ``like`` kept, no
  gradient);
* checkpoints cross both ways: the reference's `save_pytree` read by the
  port's `load_pytree` and the port's read by the reference's, on the
  bridged parameters of the elasticbert12 and rwkv6-3b smoke models in
  bfloat16 and float32, bitwise, with ``manifest.json``'s ``paths`` and
  ``dtypes`` equal as strings (the reference walks dict keys sorted at
  every level, not in ``named_parameters()`` order);
* the two ``ValueError``s, with the reference's messages, where the
  reference raises them;
* a ``like`` on the meta device loads with ``device=`` and raises
  without it.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load
from repro.checkpoint import save_pytree as j_save
from repro.configs import get_smoke_config
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.models.transformer import ParamTree

CASES = [(arch, dtype) for arch in ("elasticbert12", "rwkv6-3b")
         for dtype in ("bfloat16", "float32")]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, (dict, ParamTree)):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _bed(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(3)))
    return cfg, jp, params_from_jax(jp, device="cpu")


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {"b": {"w": torch.randn(3, 4, generator=g),
                  "a": torch.randn(5, generator=g).to(torch.bfloat16)},
            "a_ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "count": torch.tensor(7, dtype=torch.int64),
            "c": torch.randn(2, 2, generator=g).to(torch.bfloat16)}


@pytest.mark.parametrize("kind", ["ParamTree", "dict"])
def test_round_trip(tmp_path, kind):
    tree = _mixed_tree()
    like = ParamTree(tree) if kind == "ParamTree" else tree
    save_pytree(str(tmp_path), like)
    man = _manifest(tmp_path)
    assert man["paths"] == ["a_ids", "b/a", "b/w", "c", "count"]
    assert man["dtypes"] == ["int32", "bfloat16", "float32", "bfloat16",
                             "int64"]
    got = load_pytree(str(tmp_path), like)
    assert type(got) is type(like)
    assert list(got.keys()) == list(like.keys())
    pairs = list(zip(_leaves(got), _leaves(like)))
    assert len(pairs) == 5
    for (pg, g), (pw, w) in pairs:
        assert pg == pw and g.dtype == w.dtype and g.shape == w.shape
        assert not g.requires_grad
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_reference_checkpoint_loads_in_the_port(tmp_path, arch, dtype):
    _, jp, tp = _bed(arch, dtype)
    j_save(str(tmp_path), jp)
    got = load_pytree(str(tmp_path), tp)
    assert isinstance(got, ParamTree)
    assert [n for n, _ in got.named_parameters()] == \
        [n for n, _ in tp.named_parameters()]
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    assert len(flat) == len(list(got.parameters()))
    for kp, want in flat:
        leaf = got
        for k in kp:
            leaf = leaf[k.key]
        assert str(leaf.dtype).removeprefix("torch.") == want.dtype.name
        np.testing.assert_array_equal(_bits(leaf), _np_bits(want))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_port_checkpoint_loads_in_the_reference(tmp_path, arch, dtype):
    """The port's files are the reference's: the same manifest strings and
    the same arrays, and the reference's loader reads them bitwise."""
    _, jp, tp = _bed(arch, dtype)
    save_pytree(str(tmp_path / "port"), tp)
    j_save(str(tmp_path / "ref"), jp)
    port, ref = _manifest(tmp_path / "port"), _manifest(tmp_path / "ref")
    assert port["num_leaves"] == ref["num_leaves"]
    assert port["paths"] == ref["paths"]
    assert port["dtypes"] == ref["dtypes"]
    assert json.dumps(port) == json.dumps(ref)
    with np.load(tmp_path / "port" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])
    got = j_load(str(tmp_path / "port"), jp)
    for (kp, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                          jax.tree.leaves(jp)):
        assert g.dtype == w.dtype, kp
        np.testing.assert_array_equal(_np_bits(g), _np_bits(w))


def _messages(fn_ref, fn_port):
    with pytest.raises(ValueError) as ref:
        fn_ref()
    with pytest.raises(ValueError) as port:
        fn_port()
    return str(ref.value), str(port.value)


def test_value_errors_match_reference(tmp_path):
    """A wrong leaf count and a wrong leaf shape raise the reference's
    ``ValueError`` with its message."""
    _, jp, tp = _bed("elasticbert12", "float32")
    j_save(str(tmp_path / "ref"), jp)
    save_pytree(str(tmp_path / "port"), tp)
    # one leaf too few in ``like``
    j_short = {k: v for k, v in jp.items() if k != "embed"}
    t_short = {k: v for k, v in tp.items() if k != "embed"}
    for d in ("ref", "port"):
        ref, port = _messages(lambda: j_load(str(tmp_path / d), j_short),
                              lambda: load_pytree(str(tmp_path / d), t_short))
        assert ref == port
        assert "leaves, expected" in port
    # a leaf of another shape: final_norm's scale one longer
    j_bad = jax.tree.map(lambda x: x, jp)
    j_bad["final_norm"] = dict(jp["final_norm"],
                               scale=np.zeros(jp["final_norm"]["scale"].size
                                              + 1, np.float32))
    t_bad = {k: v for k, v in tp.items()}
    t_bad["final_norm"] = {"bias": tp["final_norm"]["bias"],
                           "scale": torch.zeros(j_bad["final_norm"]["scale"]
                                                .shape)}
    for d in ("ref", "port"):
        ref, port = _messages(lambda: j_load(str(tmp_path / d), j_bad),
                              lambda: load_pytree(str(tmp_path / d), t_bad))
        assert ref == port
        assert " shape " in port


def test_meta_like_needs_a_device(tmp_path):
    _, jp, _ = _bed("elasticbert12", "float32")
    cfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                              dtype="float32")
    j_save(str(tmp_path), jp)
    meta = build_model(cfg).abstract_params()
    with pytest.raises(ValueError, match="meta device.*device="):
        load_pytree(str(tmp_path), meta)
    got = load_pytree(str(tmp_path), meta, device="cpu")
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in got.parameters())
    want = load_pytree(str(tmp_path), build_model(cfg).init(device="cpu"))
    for (n, a), (m, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        assert n == m
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # an explicit device overrides the like-leaves' devices
    again = load_pytree(str(tmp_path), want, device="cpu")
    assert all(p.device.type == "cpu" for p in again.parameters())
