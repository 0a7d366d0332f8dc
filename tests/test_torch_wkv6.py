"""Port vs reference: the RWKV6 WKV recurrence.

The port's plain `wkv6_ref` and its `ops.wkv6` on CPU tensors (which runs
the plain version) against the reference's `wkv6` with its jnp oracle and
with its Pallas kernel in interpret mode, on the same numpy inputs:
float32 at rtol = atol = 1e-5, the tolerance of the reference's own
kernel sweep. The plain backward, `wkv6_backward_ref`, against
``jax.vjp`` of the reference's `wkv6_ref` and against torch autograd
(float32 gradients at GRAD_RTOL of their largest magnitude, bf16 ones at
one bfloat16 ulp), and `WKV6`'s wiring with its kernels swapped for the
plain versions. The CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as j_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_backward_ref, wkv6_ref

TOL = 1e-5

# the reference's kernel sweep (tests/test_kernels_wkv6.py)
CASES = [
    # b, h, t, dk, dv, chunk
    (1, 2, 64, 16, 16, 16),
    (2, 3, 100, 32, 32, 32),   # padded final chunk
    (1, 1, 33, 8, 8, 16),
    (2, 2, 128, 64, 64, 64),
    (1, 4, 17, 16, 16, 32),    # chunk > T
]


def _inputs(seed, b, h, t, dk, dv):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, t, dk)).astype(np.float32)
    k = rng.standard_normal((b, h, t, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, t, dv)).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.standard_normal((b, h, t, dk))))).astype(
        np.float32)
    u = (rng.standard_normal((h, dk)) * 0.5).astype(np.float32)
    return r, k, v, w, u


def _close(want, got):
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("b,h,t,dk,dv,chunk", CASES)
def test_matches_reference(b, h, t, dk, dv, chunk):
    arrs = _inputs(t * 13 + dk, b, h, t, dk, dv)
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a) for a in arrs]
    y_ref, s_ref = j_wkv6(*jx, backend="ref")
    y_pal, s_pal = j_wkv6(*jx, backend="pallas_interpret", chunk=chunk)
    reset_launch_counts()
    for y, s in (wkv6_ref(*tx), wkv6(*tx, chunk=chunk)):
        assert y.dtype == s.dtype == torch.float32
        assert y.shape == (b, h, t, dv) and s.shape == (b, h, dk, dv)
        for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
            _close(want_y, y)
            _close(want_s, s)
    assert launch_counts()["wkv6"] == 0      # CPU tensors: plain version


def _wkv6_hoisted_bonus(r, k, v, w, u):
    """The CUDA kernel's form of the recurrence, in plain torch: the bonus
    leaves the sum over i as one scalar per step,
        a_t = sum_i r_t[i] u[i] k_t[i],
        y_t[j] = sum_i r_t[i] S_{t-1}[i,j] + a_t v_t[j],
    and the state update is S <- w_t * S + k_t v_t^T."""
    b, h, t, dk = r.shape
    s = torch.zeros((b, h, dk, v.shape[-1]))
    ys = []
    for i in range(t):
        rt, kt, vt, wt = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]
        a = (rt * u * kt).sum(-1, keepdim=True)             # (B, H, 1)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s) + a * vt)
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, dim=2), s


@pytest.mark.parametrize("b,h,t,dk,dv,chunk", CASES)
def test_hoisted_bonus_form_matches_reference(b, h, t, dk, dv, chunk):
    """The kernel's algebra (bonus hoisted out of the per-column sum)
    against the reference's oracle, on the same numpy inputs."""
    arrs = _inputs(t * 7 + dk, b, h, t, dk, dv)
    y_ref, s_ref = j_wkv6_ref(*(jnp.asarray(a) for a in arrs))
    y, s = _wkv6_hoisted_bonus(*(torch.from_numpy(a) for a in arrs))
    _close(y_ref, y)
    _close(s_ref, s)


def test_initial_state_composes():
    """Two halves, the second from the first's final state, equal the
    whole sequence, and each half matches the reference's oracle."""
    b, h, t, d = 1, 2, 32, 8
    arrs = _inputs(0, b, h, t, d, d)
    r, k, v, w, u = (torch.from_numpy(a) for a in arrs)
    y_full, s_full = wkv6_ref(r, k, v, w, u)
    half = t // 2
    first = [x[:, :, :half] for x in (r, k, v, w)]
    second = [x[:, :, half:] for x in (r, k, v, w)]
    y1, s1 = wkv6_ref(*first, u)
    y2, s2 = wkv6_ref(*second, u, initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y_full, rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(s2, s_full, rtol=TOL, atol=TOL)
    j_first = [jnp.asarray(x.numpy()) for x in first]
    j_second = [jnp.asarray(x.numpy()) for x in second]
    jy1, js1 = j_wkv6_ref(*j_first, jnp.asarray(arrs[4]))
    jy2, js2 = j_wkv6_ref(*j_second, jnp.asarray(arrs[4]), initial_state=js1)
    for want, got in ((jy1, y1), (js1, s1), (jy2, y2), (js2, s2)):
        _close(want, got)


def test_bfloat16_inputs_compute_in_float32():
    """bf16 r/k/v/u with f32 w, as the bf16 model hands them over: the
    plain version upcasts and matches the reference's oracle on the same
    bf16-rounded values."""
    arrs = _inputs(7, 2, 2, 20, 16, 16)
    tx = [torch.from_numpy(a) for a in arrs]
    r, k, v, u = (x.to(torch.bfloat16) for x in (tx[0], tx[1], tx[2], tx[4]))
    y, s = wkv6(r, k, v, tx[3], u)
    jy, js = j_wkv6_ref(*(jnp.asarray(x.float().numpy())
                          for x in (r, k, v, tx[3], u)))
    _close(jy, y)
    _close(js, s)


def test_strided_view_input_matches_contiguous():
    """(B, S, H, hd) -> (B, H, S, hd) views, as time_mix passes them."""
    arrs = _inputs(3, 2, 3, 12, 8, 8)
    tx = [torch.from_numpy(a) for a in arrs]
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in tx[:4]]
    assert not views[0].is_contiguous()
    for want, got in zip(wkv6(*tx), wkv6(*views, tx[4])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_other_device_raises():
    arrs = _inputs(1, 1, 1, 4, 4, 4)
    meta = [torch.from_numpy(a).to("meta") for a in arrs]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wkv6(*meta)


def test_kernel_inputs_cast_to_the_kernel_dtypes():
    """What the CUDA path hands the kernel: r/k/v kept when all f32 or all
    bf16, else all f32; w and u always f32."""
    from repro_torch.kernels.wkv6.ops import _kernel_inputs
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    x = torch.ones((1, 1, 2, 4))
    u = torch.ones((1, 4))
    cases = [
        ((bf16, bf16, bf16, f32, bf16), (bf16, bf16, bf16, f32, f32)),
        ((f32, f32, f32, bf16, f32), (f32, f32, f32, f32, f32)),
        ((bf16, f32, bf16, f32, f16), (f32, f32, f32, f32, f32)),
        ((f16, f16, f16, f16, bf16), (f32, f32, f32, f32, f32)),
    ]
    for given, want in cases:
        args = [x.to(dt) for dt in given[:4]] + [u.to(given[4])]
        assert tuple(t.dtype for t in _kernel_inputs(*args)) == want


def test_cuda_binding_rejects_cpu_tensors():
    """The kernel's binding checks devices before it builds or launches."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    arrs = [torch.from_numpy(a) for a in _inputs(2, 1, 2, 3, 8, 8)]
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv6_cuda(*arrs)


@pytest.mark.parametrize("mesh_shape,placements", [
    ((1, 2), ("R", "S1")),         # heads over "model"
    ((2, 2), ("S0", "S1")),        # batch over "data", heads over "model"
    ((2, 1), ("S0", "R")),         # batch only
])
def test_dtensor_head_shards_equal_the_whole_call(mesh_shape, placements):
    """``DTensor`` r/k/v (and a replicated w, placed as r by the wrapper)
    split over heads and the batch: each rank runs its shard with ``u``
    sliced to its heads; the result and the state, placed as r, gathered
    whole, equal the whole call (the same float32 loop per head:
    bitwise). A split inside a head (dk) or over time raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from _threaded_ranks import run_ranks
    from repro_torch.launch.mesh import make_mesh
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(3, 2, 4, 9, 8, 8))
    want = wkv6(r, k, v, w, u)
    pl = [Shard(int(p[1])) if p.startswith("S") else Replicate()
          for p in placements]

    def rank(_):
        mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        rd, kd, vd = (distribute_tensor(t, mesh, pl) for t in (r, k, v))
        wd = distribute_tensor(w, mesh, [Replicate(), Replicate()])
        y, s = wkv6(rd, kd, vd, wd, u)
        assert y.placements == s.placements == rd.placements
        for bad in (Shard(3), Shard(2)):
            split = distribute_tensor(r, mesh, [Replicate(), bad])
            with pytest.raises(ValueError, match="whole heads"):
                wkv6(split, split, split, split, u)
        return y.full_tensor(), s.full_tensor()

    for y, s in run_ranks(rank, mesh_shape[0] * mesh_shape[1]).values():
        assert torch.equal(y, want[0]) and torch.equal(s, want[1])


# ------------------------------------------------------------ the backward

# (b, h, t, dk, dv, dtype of r/k/v): dk != dv, T off the CUDA backward's
# checkpoint chunk (4 steps), bf16 r/k/v
BACKWARD_CASES = [
    (2, 3, 37, 8, 8, "float32"),
    (1, 2, 33, 16, 8, "float32"),
    (2, 2, 9, 8, 12, "float32"),
    (1, 3, 1, 4, 4, "float32"),
    (2, 2, 21, 16, 16, "bfloat16"),
]
# float32 gradients, sums over T and over the state taken in other orders
# (relative to the gradient's largest magnitude)
GRAD_RTOL = 1e-5
# bf16 dr/dk/dv: both sides round float32 values that agree to GRAD_RTOL
# to bfloat16, so they differ by at most one bfloat16 ulp (2^-7 of the
# value)
BF16_GRAD_RTOL = 2 ** -7


def _backward_inputs(seed, b, h, t, dk, dv, dtype):
    """r, k, v, w, u as `_inputs` (r/k/v rounded to ``dtype``), w drawn as
    the model's `_decay` draws it (down to exp(-e^2)), and the cotangents
    dy and a nonzero final-state ds."""
    rng = np.random.default_rng(seed)
    r, k, v, _, u = _inputs(seed, b, h, t, dk, dv)
    w = np.exp(-np.exp(np.clip(rng.standard_normal((b, h, t, dk)) * 2.0,
                               -10.0, 2.0))).astype(np.float32)
    dy = rng.standard_normal((b, h, t, dv)).astype(np.float32)
    ds = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    tdt = getattr(torch, dtype)
    r, k, v = (torch.from_numpy(a).to(tdt) for a in (r, k, v))
    return (r, k, v, torch.from_numpy(w), torch.from_numpy(u),
            torch.from_numpy(dy), torch.from_numpy(ds))


def _assert_grads_close(got, want, names=("dr", "dk", "dv", "dw", "du")):
    for name, g, w in zip(names, got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        low = name in ("dr", "dk", "dv") and got[0].dtype == torch.bfloat16
        rel = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert rel <= (BF16_GRAD_RTOL if low else GRAD_RTOL), (name, rel)


@pytest.mark.parametrize("b,h,t,dk,dv,dtype", BACKWARD_CASES)
def test_backward_ref_matches_reference_vjp(b, h, t, dk, dv, dtype):
    """`wkv6_backward_ref` against ``jax.vjp`` of the reference's
    `wkv6_ref` on the same inputs and cotangents (dy and a nonzero
    final-state ds), all five gradients; dtypes as the CUDA kernel
    returns them (dr/dk/dv in r's dtype, dw and du float32)."""
    r, k, v, w, u, dy, ds = _backward_inputs(t * 7 + dk, b, h, t, dk, dv,
                                             dtype)
    got = wkv6_backward_ref(r, k, v, w, u, dy, ds)
    assert [g.dtype for g in got] == [r.dtype] * 3 + [torch.float32] * 2
    assert got[4].shape == (h, dk)
    jx = [jnp.asarray(x.float().numpy()) for x in (r, k, v, w, u)]
    _, vjp = jax.vjp(j_wkv6_ref, *jx)
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(ds.numpy())))
    if dtype == "bfloat16":    # the reference's gradients, rounded as ours
        want = [np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                           .astype(jnp.float32)) if i < 3 else g
                for i, g in enumerate(want)]
    _assert_grads_close(got, want)


@pytest.mark.parametrize("b,h,t,dk,dv,dtype", BACKWARD_CASES)
@pytest.mark.parametrize("with_state", [True, False])
def test_backward_ref_matches_autograd(b, h, t, dk, dv, dtype, with_state):
    """`wkv6_backward_ref` against torch autograd of `wkv6_ref`, with and
    without a cotangent for the final state."""
    r, k, v, w, u, dy, ds = _backward_inputs(t * 11 + dv, b, h, t, dk, dv,
                                             dtype)
    leaves = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    y, s = wkv6_ref(*leaves)
    loss = (y * dy).sum() + ((s * ds).sum() if with_state else 0.0)
    # (at T = 1 without the state, y does not read w: its gradient is 0)
    want = torch.autograd.grad(loss, leaves, materialize_grads=True)
    got = wkv6_backward_ref(r, k, v, w, u, dy, ds if with_state else None)
    assert [g.dtype for g in want[:3]] == [g.dtype for g in got[:3]]
    _assert_grads_close(got, [g.float().numpy() for g in want])


def test_backward_ref_in_float64_is_a_float64_reading():
    """Given float64 inputs the plain backward computes in float64 (the
    reading the card's float32 backward is held against)."""
    r, k, v, w, u, dy, ds = _backward_inputs(5, 1, 2, 40, 8, 8, "float32")
    got = wkv6_backward_ref(*(x.double() for x in (r, k, v, w, u, dy, ds)))
    assert all(g.dtype == torch.float64 for g in got)
    _assert_grads_close(got, [g.numpy() for g in wkv6_backward_ref(
        r, k, v, w, u, dy, ds)])


@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_function_gives_autograds_gradients(monkeypatch, use_state,
                                                 dtype):
    """`WKV6`'s wiring, with its two kernels swapped for their plain
    versions: the gradients and dtypes of autograd through `wkv6_ref`
    (after `_kernel_inputs`' casts, which autograd carries back), and
    ``None`` for the final state's cotangent when the state is unused."""
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ops import WKV6, _kernel_inputs
    seen = []

    def backward(*args):
        seen.append(args[-1])
        return wkv6_backward_ref(*args)
    monkeypatch.setattr(ops, "wkv6_cuda", wkv6_ref)
    monkeypatch.setattr(ops, "wkv6_backward_cuda", backward)
    r, k, v, w, u, dy, ds = _backward_inputs(9, 2, 3, 13, 8, 8, dtype)
    u = u.to(r.dtype)                   # cast to float32 by _kernel_inputs

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
        y, s = fn(*leaves)
        loss = (y * dy).sum() + ((s * ds).sum() if use_state else 0.0)
        return torch.autograd.grad(loss, leaves)
    got = grads(lambda *x: WKV6.apply(*_kernel_inputs(*x)))
    want = grads(wkv6_ref)
    assert len(seen) == 1 and (seen[0] is None) == (not use_state)
    assert [g.dtype for g in got] == [g.dtype for g in want]
    _assert_grads_close(got, [g.float().numpy() for g in want])
