"""Port vs reference: the RWKV6 WKV recurrence.

The port's plain `wkv6_ref` and its `ops.wkv6` on CPU tensors (which runs
the plain version) against the reference's `wkv6` with its jnp oracle and
with its Pallas kernel in interpret mode, on the same numpy inputs:
float32 at rtol = atol = 1e-5, the tolerance of the reference's own
kernel sweep. The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as j_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref

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
