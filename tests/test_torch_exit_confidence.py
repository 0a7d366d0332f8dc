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


# ------------------------------------------- vocabulary shards (partials)

def _shard_edges(v, shards):
    """Column edges of ``shards`` contiguous shards of V, uneven where V
    does not divide (the first shards take the remainder)."""
    base, rem = divmod(v, shards)
    sizes = [base + (1 if i < rem else 0) for i in range(shards)]
    return np.concatenate([[0], np.cumsum(sizes)]).tolist()


def _combined(h, w, bias, shards, norm=None):
    """conf, pred through the partials of each shard, gathered in shard
    order and combined: the plain form of the vocabulary-split exit."""
    from repro_torch.kernels.exit_confidence.ref import (
        combine_partials_ref, exit_partials_fused_ref, exit_partials_ref)
    edges = _shard_edges(w.shape[-1], shards)
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        wb = w[..., lo:hi]
        bb = None if bias is None else bias[..., lo:hi]
        parts.append(exit_partials_ref(h, wb, bb, col0=lo) if norm is None
                     else exit_partials_fused_ref(h, norm[0], wb, bb,
                                                  kind=norm[1], col0=lo))
    return combine_partials_ref(*(torch.cat([p[i] for p in parts], dim=-2)
                                  for i in range(3)))


def _check_close(want, got):
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-7)
    assert torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("grouped", [False, True])
def test_partials_and_combine_equal_whole_rows(shards, grouped):
    """V = 37 (divides none of 2, 3, 4) split into contiguous shards, each
    shard's triple with global columns, combined: the whole-row plain
    version's conf (1e-6: the sums add in another order) and pred, and
    the reference's."""
    from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref
    rng = np.random.default_rng(shards)
    lead = (3,) if grouped else ()
    h = _rand(rng, *lead, 6, 16)
    w, bias = _rand(rng, *lead, 16, 37, scale=0.3), _rand(rng, *lead, 37)
    want = exit_confidence_ref(_t(h), _t(w), _t(bias))
    _check_close(want, _combined(_t(h), _t(w), _t(bias), shards))
    if not grouped:
        _check(j_exit(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
                      block_v=16, **INTERP),
               _combined(_t(h), _t(w), _t(bias), shards))


@pytest.mark.parametrize("shards", [2, 3])
def test_partials_ties_across_a_shard_boundary_go_to_the_lowest_column(
        shards):
    """Equal maxima in two shards (columns 5 and 30 of 37, and 12 / 13 on
    both sides of a 2-shard edge at 19 when it lies there): the lowest
    global column wins, as in the whole row."""
    d, v = 8, 37
    h = torch.ones(3, d)
    for cols in ((5, 30), (18, 19), (12, 36)):
        w = torch.zeros(d, v)
        for c in cols:
            w[:, c] = 2.0
        conf, pred = _combined(h, w, None, shards)
        assert (pred == min(cols)).all(), (cols, pred)
        _check_close(exit_confidence(h, w), (conf, pred))


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("per_row", [False, True])
def test_fused_partials_and_combine_equal_whole_rows(kind, per_row):
    """The fused form's partials (the exit norm, shared or per-row
    parameters, before each shard's product) combined over 3 shards equal
    the whole-row fused plain version."""
    from repro_torch.kernels.exit_confidence.ref import \
        exit_confidence_fused_ref
    rng = np.random.default_rng(5)
    x, w = _rand(rng, 6, 16, scale=3.0), _rand(rng, 16, 37, scale=0.3)
    rows = (6, 16) if per_row else (16,)
    norm = {"scale": _t(1.0 + _rand(rng, *rows, scale=0.1)),
            "bias": _t(_rand(rng, *rows, scale=0.1))}
    want = exit_confidence_fused_ref(_t(x), norm, _t(w), kind=kind)
    _check_close(want, _combined(_t(x), _t(w), None, 3, norm=(norm, kind)))


def test_partials_and_combine_dispatch_by_device():
    """`exit_partials`, `exit_partials_fused` and `exit_combine` run the
    plain versions on CPU tensors (counting no launch) and raise on other
    devices; the CUDA bindings refuse CPU tensors before any build."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.exit_confidence.kernel import (
        exit_combine_cuda, exit_partials_cuda)
    from repro_torch.kernels.exit_confidence.ops import (
        exit_combine, exit_partials, exit_partials_fused)
    from repro_torch.kernels.exit_confidence.ref import (
        exit_confidence_fused_ref, exit_confidence_ref)
    rng = np.random.default_rng(13)
    h, w = _t(_rand(rng, 5, 16)), _t(_rand(rng, 16, 9, scale=0.3))
    norm = {"scale": torch.ones(16)}
    reset_launch_counts()
    parts = [exit_partials(h, w[:, :4], col0=0),
             exit_partials(h, w[:, 4:], col0=4)]
    tri = [torch.cat([p[i] for p in parts]) for i in range(3)]
    _check_close(exit_confidence_ref(h, w), exit_combine(*tri))
    fparts = [exit_partials_fused(h, norm, w[:, :4], kind="rmsnorm"),
              exit_partials_fused(h, norm, w[:, 4:], kind="rmsnorm", col0=4)]
    _check_close(exit_confidence_fused_ref(h, norm, w, kind="rmsnorm"),
                 exit_combine(*(torch.cat([p[i] for p in fparts])
                                for i in range(3))))
    assert not any(launch_counts().values())
    meta = torch.empty((2, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        exit_combine(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        exit_partials(torch.empty((5, 16), device="meta"),
                      torch.empty((16, 9), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        exit_combine_cuda(*tri)
    with pytest.raises(ValueError, match="CUDA"):
        exit_partials_cuda(h, w, col0=0)
