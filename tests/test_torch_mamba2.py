"""Port vs reference: the Mamba2 (SSD) block of the hybrid family.

The reference's `init_mamba2` at the zamba2-1.2b smoke widths (d 128,
expand 2: 4 heads of 64, state N 16, chunk 16) in float32, with its
decay, step and skip parameters redrawn from a numpy seed so that no
term is trivial, is bridged into the port; inputs and starting states
come from the same seed:

* `_causal_conv` (output and the new conv state), `_ssd_chunked` (output
  and final state, on the zero-padded length as `mamba2_forward` pads)
  and `mamba2_forward` (output, conv and SSD states) at S in {1, 16,
  20, 37}: S = 1 is the exact one-step recurrence, 20 and 37 are padded
  to the chunk, 37 crosses three chunks;
* S one-token steps from the zero state reach the chunked prefill's
  final states and outputs;
* the bf16 block keeps its conv state and SSD state in float32, as the
  reference does.

rtol = atol = 1e-5 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm2
from repro_torch.bridge import tensor_from_numpy
from repro_torch.models import mamba2 as tm2

RTOL = ATOL = 1e-5
D, N, EXPAND, CHUNK = 128, 16, 2, 16
SEQS = [1, 16, 20, 37]


def _params(dtype=jnp.float32, seed=0):
    jp = jm2.init_mamba2(jax.random.PRNGKey(seed), D, N, EXPAND, dtype)
    rng = np.random.default_rng(seed)
    h = jp["a_log"].shape[0]
    jp = dict(jp)
    jp["a_log"] = jnp.asarray(rng.normal(0.0, 0.5, h), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.normal(-1.0, 0.5, h), jnp.float32)
    jp["d_skip"] = jnp.asarray(rng.normal(1.0, 0.3, h), jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.normal(0.0, 0.1, jp["conv_b"].shape),
                               dtype)
    jp["norm_scale"] = jnp.asarray(
        rng.normal(1.0, 0.1, jp["norm_scale"].shape), dtype)
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jp, tp


def _state(b, seed, zero=False):
    st = jm2.init_mamba2_state(b, D, N, EXPAND)
    if zero:
        return st
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray(rng.standard_normal(v.shape) * 0.5, jnp.float32)
            for k, v in st.items()}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("s", SEQS)
def test_causal_conv_matches_reference(s):
    jp, tp = _params()
    rng = np.random.default_rng(s)
    c = jp["conv_w"].shape[1]
    x = rng.standard_normal((2, s, c)).astype(np.float32)
    st = rng.standard_normal((2, jm2.CONV_K - 1, c)).astype(np.float32)
    want, want_st = jm2._causal_conv(jnp.asarray(x), jp["conv_w"],
                                     jp["conv_b"], jnp.asarray(st))
    got, got_st = tm2._causal_conv(torch.from_numpy(x), tp["conv_w"],
                                   tp["conv_b"], torch.from_numpy(st))
    _close(got, want)
    _close(got_st, want_st)


@pytest.mark.parametrize("s", SEQS)
def test_ssd_chunked_matches_reference(s):
    """On the zero-padded length, as `mamba2_forward` calls it, from a
    random starting state."""
    rng = np.random.default_rng(100 + s)
    sp = -(-s // CHUNK) * CHUNK
    h, p = EXPAND * D // jm2.HEAD_DIM, jm2.HEAD_DIM

    def padded(shape, scale=1.0, positive=False):
        a = rng.standard_normal(shape) * scale
        a = np.abs(a) if positive else a
        a = a.astype(np.float32)
        out = np.zeros((shape[0], sp) + shape[2:], np.float32)
        out[:, :s] = a
        return out

    xh = padded((2, s, h, p))
    bm = padded((2, s, N), 0.5)
    cm = padded((2, s, N), 0.5)
    dt = padded((2, s, h), 0.5, positive=True)
    a = -np.exp(rng.normal(0.0, 0.5, h)).astype(np.float32)
    h0 = (rng.standard_normal((2, h, p, N)) * 0.5).astype(np.float32)
    want_y, want_h = jm2._ssd_chunked(*map(jnp.asarray, (xh, bm, cm, dt, a,
                                                         h0)), CHUNK)
    got_y, got_h = tm2._ssd_chunked(*map(torch.from_numpy, (xh, bm, cm, dt,
                                                            a, h0)), CHUNK)
    _close(got_y, want_y)
    _close(got_h, want_h)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tm2._ssd_chunked(*map(torch.from_numpy, (xh, bm, cm, dt, a, h0)),
                         CHUNK + 1)


@pytest.mark.parametrize("s", SEQS)
def test_mamba2_forward_matches_reference(s):
    jp, tp = _params()
    x = np.random.default_rng(200 + s).standard_normal(
        (3, s, D)).astype(np.float32)
    st = _state(3, s)
    want, want_st = jm2.mamba2_forward(jp, jnp.asarray(x), st, state_size=N,
                                       expand=EXPAND, chunk=CHUNK)
    got, got_st = tm2.mamba2_forward(tp, torch.from_numpy(x),
                                     {k: _t(v) for k, v in st.items()},
                                     state_size=N, expand=EXPAND,
                                     chunk=CHUNK)
    _close(got, want)
    assert sorted(got_st) == sorted(want_st) == ["conv", "ssm"]
    for key in got_st:
        assert got_st[key].dtype == torch.float32
        _close(got_st[key], want_st[key])


def test_one_token_steps_reach_the_chunked_state():
    """37 one-token steps (the exact recurrence) from the zero state give
    the chunked prefill's outputs and final states."""
    jp, tp = _params(seed=3)
    s = 37
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, s, D)).astype(np.float32))
    zero = {k: _t(v) for k, v in _state(2, 0, zero=True).items()}
    full, full_st = tm2.mamba2_forward(tp, x, zero, state_size=N,
                                       expand=EXPAND, chunk=CHUNK)
    st, outs = zero, []
    for t in range(s):
        y, st = tm2.mamba2_forward(tp, x[:, t:t + 1], st, state_size=N,
                                   expand=EXPAND, chunk=CHUNK)
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy())
    for key in ("conv", "ssm"):
        _close(st[key], full_st[key].numpy())


def test_bf16_states_stay_float32():
    """A bf16 block (w_in, conv_w in bf16; a_log, dt_bias, d_skip f32):
    output in bf16, both states float32 and equal to the reference's
    within bf16 rounding."""
    jp, tp = _params(dtype=jnp.bfloat16)
    assert tp["w_in"].dtype == torch.bfloat16
    assert tp["a_log"].dtype == tp["dt_bias"].dtype == torch.float32
    x = np.random.default_rng(9).standard_normal((2, 20, D)).astype(
        np.float32)
    st = _state(2, 9)
    want, want_st = jm2.mamba2_forward(jp, jnp.asarray(x, jnp.bfloat16), st,
                                       state_size=N, expand=EXPAND,
                                       chunk=CHUNK)
    got, got_st = tm2.mamba2_forward(
        tp, torch.from_numpy(x).to(torch.bfloat16),
        {k: _t(v) for k, v in st.items()}, state_size=N, expand=EXPAND,
        chunk=CHUNK)
    assert got.dtype == torch.bfloat16
    for key in ("conv", "ssm"):
        assert got_st[key].dtype == torch.float32
        assert np.asarray(want_st[key]).dtype == np.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_allclose(got_st["conv"].numpy(),
                               np.asarray(want_st["conv"]), rtol=0, atol=0)
