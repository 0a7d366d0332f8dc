"""Port vs reference: the top-k MoE block (dense dispatch).

The reference's `init_moe` (d 128, d_ff 256, 4 experts, top-2) in
float32 is bridged into the port; tokens come from a numpy seed. Against
the reference's `moe_forward`, outputs at rtol = atol = 1e-5 and the aux
loss at 1e-6, in four routings:

* no drops (a capacity factor that fits every entry);
* forced drops: a router skewed towards expert 0 at the default capacity
  factor 1.25, where the capacity is that of the call's B·S tokens and
  the overflow of the token-major cumsum is dropped;
* the drop-free decode capacity (factor = E) under the same skew;
* equal router logits (a zero router), where every token's top-2 must be
  experts 0 and 1, as `lax.top_k` orders equal values (lower index
  first), and the tie itself overflows their capacity.

The port's `moe_route` also gives the kept/dropped entries, which are
held against the reference's capacity arithmetic recomputed in numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jff
from repro_torch.bridge import tensor_from_numpy
from repro_torch.models import mlp as tff

RTOL = ATOL = 1e-5
AUX_ATOL = 1e-6
D, F, E, K = 128, 256, 4, 2


def _params(router="random", seed=0):
    jp = dict(jff.init_moe(jax.random.PRNGKey(seed), D, F, E, jnp.float32))
    if router == "skewed":
        r = np.asarray(jp["router"]).copy()
        r[:, 0] += 0.05     # with tokens of mean 0.5: expert 0 leads by ~3
        jp["router"] = jnp.asarray(r)
    elif router == "equal":
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jp, tp


def _tokens(b=4, s=8, seed=1, mean=0.0):
    return (np.random.default_rng(seed).standard_normal((b, s, D))
            + mean).astype(np.float32)


def _numpy_keep(top_e, capacity):
    """The reference's position-in-expert over the token-major entries."""
    flat = np.asarray(top_e).reshape(-1)
    seen = np.zeros(E, np.int64)
    keep = np.zeros(flat.shape, bool)
    for j, e in enumerate(flat):
        keep[j] = seen[e] < capacity
        seen[e] += 1
    return keep


CASES = {
    "no_drops": ("random", 4.0),
    "forced_drops": ("skewed", 1.25),
    "decode_capacity": ("skewed", float(E)),
    "equal_logits": ("equal", 1.25),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_reference(case):
    router, cf = CASES[case]
    jp, tp = _params(router)
    x = _tokens(mean=0.5 if router == "skewed" else 0.0)
    want, want_aux = jff.moe_forward(jp, jnp.asarray(x), num_experts=E,
                                     top_k=K, capacity_factor=cf)
    xt = torch.from_numpy(x)
    got, got_aux = tff.moe_forward(tp, xt, num_experts=E, top_k=K,
                                   capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert got_aux.dtype == torch.float32
    assert abs(float(got_aux) - float(want_aux)) <= AUX_ATOL

    r = tff.moe_route(tp, xt.reshape(-1, D), num_experts=E, top_k=K,
                      capacity_factor=cf)
    t = x.shape[0] * x.shape[1]
    assert r["capacity"] == int(max(K * t * cf / E, K))
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, D) @ jp["router"], -1)
    _, ref_e = jax.lax.top_k(probs, K)
    np.testing.assert_array_equal(r["top_e"].numpy(), np.asarray(ref_e))
    keep = r["keep"].numpy()
    np.testing.assert_array_equal(keep, _numpy_keep(ref_e, r["capacity"]))
    dropped = int((~keep).sum())
    if case in ("no_drops", "decode_capacity"):
        assert dropped == 0
    else:
        assert dropped > 0
    if case == "equal_logits":
        np.testing.assert_array_equal(r["top_e"].numpy(),
                                      np.tile([0, 1], (t, 1)))
        np.testing.assert_allclose(r["top_p"].numpy(), 0.5, rtol=0, atol=0)


def test_top_k_ties_take_the_lower_index():
    """Equal probabilities anywhere in a row: the lower expert first, as
    `lax.top_k` returns them."""
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.4, 0.1, 0.4],
                        [0.3, 0.2, 0.3, 0.2],
                        [0.1, 0.2, 0.3, 0.4]], np.float32)
    vals, idx = tff.top_k_experts(torch.from_numpy(probs), K)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(probs), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))


def test_moe_grads_match_reference():
    """Gradients of sum(out²) + aux with respect to the input and every
    expert leaf, through the dispatch and the combine, at a capacity that
    drops entries."""
    jp, tp = _params("skewed")
    x = _tokens(2, 8, seed=4, mean=0.5)

    def jloss(params, xx):
        out, aux = jff.moe_forward(params, xx, num_experts=E, top_k=K)
        return jnp.sum(out * out) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tff.moe_forward(tp, xt, num_experts=E, top_k=K)
    (torch.sum(out * out) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-4,
                               atol=1e-5)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg_p[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
