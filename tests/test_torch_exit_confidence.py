"""Port vs reference: the exit-confidence ops, plain and fused.

The port's ops on CPU tensors (their plain versions) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs:
conf at atol 1e-6, pred exactly equal (inputs keep the top-2 logits of
every row apart, except in the tie tests, whose integer inputs make the
tied logits exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.exit_confidence.ops import exit_confidence as j_exit
from repro.kernels.exit_confidence.ops import \
    exit_confidence_fused as j_fused
from repro_torch.kernels.exit_confidence.ops import (exit_confidence,
                                                     exit_confidence_fused)

CONF_ATOL = 1e-6
INTERP = dict(backend="pallas_interpret")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(ref, got):
    (c0, p0), (c1, p1) = ref, got
    np.testing.assert_allclose(np.asarray(c0), c1.numpy(), rtol=0,
                               atol=CONF_ATOL)
    np.testing.assert_array_equal(np.asarray(p0), p1.numpy())
    assert p1.dtype == torch.int32 and c1.dtype == torch.float32


@pytest.mark.parametrize("b,d,v", [(8, 128, 2), (5, 64, 3), (16, 96, 700)])
def test_exit_confidence_matches_reference(b, d, v):
    rng = np.random.default_rng(b + d + v)
    h, w = _rand(rng, b, d), _rand(rng, d, v, scale=0.2)
    ref = j_exit(jnp.asarray(h), jnp.asarray(w), block_v=256, **INTERP)
    _check(ref, exit_confidence(_t(h), _t(w)))


def test_bias_folding_matches_reference():
    rng = np.random.default_rng(7)
    h, w, bias = _rand(rng, 4, 32), _rand(rng, 32, 65, scale=0.2), \
        _rand(rng, 65)
    ref = j_exit(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
                 block_v=32, **INTERP)
    _check(ref, exit_confidence(_t(h), _t(w), _t(bias)))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("v,with_bias", [(2, False), (130, True)])
def test_fused_matches_reference(kind, v, with_bias):
    rng = np.random.default_rng(11 + v)
    b, d = 6, 128
    x = _rand(rng, b, d, scale=2.0) + 0.3
    norm = {"scale": _rand(rng, d) + 1.0, "bias": _rand(rng, d, scale=0.1)}
    if kind == "rmsnorm":
        del norm["bias"]
    w = _rand(rng, d, v, scale=0.2)
    bias = _rand(rng, v) if with_bias else None
    ref = j_fused(jnp.asarray(x), {k: jnp.asarray(a) for k, a in norm.items()},
                  jnp.asarray(w), None if bias is None else jnp.asarray(bias),
                  kind=kind, block_v=64, **INTERP)
    got = exit_confidence_fused(_t(x), {k: _t(a) for k, a in norm.items()},
                                _t(w), None if bias is None else _t(bias),
                                kind=kind)
    _check(ref, got)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_fused_per_row_norm_params(kind):
    rng = np.random.default_rng(13)
    b, d, v = 5, 64, 2
    x = _rand(rng, b, d)
    norm = {"scale": _rand(rng, b, d, scale=0.1) + 1.0,
            "bias": _rand(rng, b, d, scale=0.1)}
    if kind == "rmsnorm":
        del norm["bias"]
    w = _rand(rng, d, v, scale=0.2)
    ref = j_fused(jnp.asarray(x), {k: jnp.asarray(a) for k, a in norm.items()},
                  jnp.asarray(w), kind=kind, **INTERP)
    got = exit_confidence_fused(_t(x), {k: _t(a) for k, a in norm.items()},
                                _t(w), kind=kind)
    _check(ref, got)


def test_fused_rmsnorm_ignores_a_norm_bias_entry():
    """An rmsnorm parameter dict carrying a "bias" entry: the port follows
    the reference's apply_norm, which ignores it (the reference's fused
    Pallas kernel adds it; see ROADMAP Queue 3)."""
    rng = np.random.default_rng(19)
    x, w = _rand(rng, 4, 32), _rand(rng, 32, 5, scale=0.3)
    norm = {"scale": _rand(rng, 32, scale=0.1) + 1.0,
            "bias": _rand(rng, 32)}
    ref = j_fused(jnp.asarray(x), {k: jnp.asarray(a) for k, a in norm.items()},
                  jnp.asarray(w), kind="rmsnorm", backend="ref")
    got = exit_confidence_fused(_t(x), {k: _t(a) for k, a in norm.items()},
                                _t(w), kind="rmsnorm")
    _check(ref, got)
    no_bias = exit_confidence_fused(_t(x), {"scale": _t(norm["scale"])},
                                    _t(w), kind="rmsnorm")
    _check(ref, no_bias)


def test_grouped_heads_equal_per_head_calls():
    """The (G, B, D) x (G, D, V) form is the reference's vmap over heads."""
    rng = np.random.default_rng(17)
    g, b, d, v = 3, 4, 32, 2
    h, w = _rand(rng, g, b, d), _rand(rng, g, d, v)
    norm = {"scale": _rand(rng, g, d) + 1.0, "bias": _rand(rng, g, d)}
    conf, pred = exit_confidence(_t(h), _t(w))
    fconf, fpred = exit_confidence_fused(_t(h), {k: _t(a) for k, a in norm.items()},
                                         _t(w), kind="layernorm")
    for i in range(g):
        _check(j_exit(jnp.asarray(h[i]), jnp.asarray(w[i]), **INTERP),
               (conf[i], pred[i]))
        _check(j_fused(jnp.asarray(h[i]),
                       {k: jnp.asarray(a[i]) for k, a in norm.items()},
                       jnp.asarray(w[i]), kind="layernorm", **INTERP),
               (fconf[i], fpred[i]))


def test_argmax_ties_go_to_lowest_index_across_tiles():
    """Exact ties straddling the reference kernel's vocab tiles resolve to
    the lowest index on both sides."""
    d, v, block_v = 8, 70, 32
    h = np.ones((3, d), np.float32)
    w = np.zeros((d, v), np.float32)
    for j in (10, 40, 65):
        w[:, j] = 2.0
    ref = j_exit(jnp.asarray(h), jnp.asarray(w), block_b=2, block_v=block_v,
                 **INTERP)
    got = exit_confidence(_t(h), _t(w))
    assert (got[1].numpy() == 10).all()
    _check(ref, got)
    w2 = np.zeros((d, v), np.float32)
    w2[:, 40] = w2[:, 41] = 3.0
    ref = j_exit(jnp.asarray(h), jnp.asarray(w2), block_v=block_v, **INTERP)
    got = exit_confidence(_t(h), _t(w2))
    assert (got[1].numpy() == 40).all()
    _check(ref, got)


def test_fused_rejects_unknown_kind_and_device():
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match="unknown"):
        exit_confidence_fused(x, {"scale": torch.ones(4)}, torch.ones(4, 2),
                              kind="batchnorm")
    m = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        exit_confidence(m, torch.empty((4, 2), device="meta"))
