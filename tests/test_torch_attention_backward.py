"""Attention's gradient through the saved row log-sum-exp, on the CPU.

The backward kernel (`flash_attention_backward_cuda`) runs only on the
card, where chip_smoke.py holds it against autograd of the plain version.
Here the pieces around it that the CPU reaches:

* `attention_lse_ref` against `jax.nn.logsumexp` of the reference's
  masked logits (`repro.kernels.flash_attention.ref.mha_ref`'s), +inf on
  the rows with no key to attend;
* `ref.attention_backward` given ``lse`` (P = exp(S·scale − lse)) equal to
  its softmax form at every `ATTN_CASES` shape of test_torch_train.py and
  at rows without keys, whole and over (batch, KV-group) slices;
* `ops.flash_attention_backward`'s dispatch by device, and
  `FlashAttention` wired end to end with the kernels swapped for their
  plain versions (a dO of stride 0 included);
* `chip_smoke.train_backward_launches` against the backward passes one
  CPU `make_train_step` step takes through block attention, and
  `chip_smoke.train_backward_tiles` (those launches by the tile
  `attention_backward_tile` picks) at the families' training shapes.

Tolerances: LSE_RTOL and BWD_RTOL, float32 sums of the same products in
other orders.
"""
import contextlib
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.flash_attention.ref import (attention_backward,
                                                     attention_lse_ref,
                                                     gqa_ref)
from repro_torch.launch import train as ttrain
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig
from test_torch_train import ATTN_CASES

LSE_RTOL = 1e-5
BWD_RTOL = 1e-5

ROOT = Path(__file__).resolve().parents[1]

# ATTN_CASES and rows without keys (causal, Sq > Skv)
BWD_CASES = ATTN_CASES + [
    # b, hq, hkv, sq, skv, d, causal, window
    (2, 4, 2, 20, 7, 16, True, 0),
    (1, 2, 2, 9, 4, 8, True, 3),
]


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


def _kernel_out(q, k, v, **kw):
    """The forward kernel's output: the plain version's, and exactly 0 on
    the rows with no key to attend."""
    out = gqa_ref(q, k, v, **kw)
    lse = attention_lse_ref(q, k, **kw)
    return out.masked_fill(torch.isinf(lse)[..., None], 0.0), lse


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 4, 4, 16, 16, 8, False, 0),
    (1, 4, 2, 12, 12, 8, True, 0),
    (1, 2, 2, 20, 20, 8, True, 5),
    (2, 4, 2, 11, 5, 8, True, 0),        # the first 6 rows see no key
])
def test_attention_lse_ref_matches_reference_logsumexp(b, hq, hkv, sq, skv,
                                                      d, causal, window):
    q, k, _, _ = _qkv(b, hq, hkv, sq, skv, d, seed=sq * skv)
    kr = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kr) * d ** -0.5
    q_pos = jnp.arange(sq)[:, None] + (skv - sq)
    k_pos = jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, logits, -1e30),
                                       axis=-1))
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, window=window).numpy()
    keyless = ~np.asarray(mask).any(-1)
    assert got.dtype == np.float32 and got.shape == (b, hq, sq)
    assert np.isposinf(got[..., keyless]).all()
    assert np.isfinite(got[..., ~keyless]).all()
    np.testing.assert_allclose(got[..., ~keyless], want[..., ~keyless],
                               rtol=LSE_RTOL, atol=LSE_RTOL)
    assert keyless.any() == (sq > skv and causal)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_CASES)
def test_attention_backward_with_lse_equals_softmax_form(b, hq, hkv, sq,
                                                         skv, d, causal,
                                                         window):
    q, k, v, dout = map(torch.from_numpy,
                        _qkv(b, hq, hkv, sq, skv, d, seed=sq + skv))
    kw = dict(causal=causal, window=window)
    out, lse = _kernel_out(q, k, v, **kw)
    want = attention_backward(q, k, v, out, dout, scale=d ** -0.5, **kw)
    got = attention_backward(q, k, v, out, dout, scale=d ** -0.5, lse=lse,
                             **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=BWD_RTOL, atol=BWD_RTOL)
    keyless = torch.isinf(lse)
    assert bool(keyless.any()) == (sq > skv and causal)
    assert (got[0][keyless] == 0).all()


def test_sliced_attention_backward_with_lse(monkeypatch):
    """Over (batch, KV-group) slices each slice reads its rows of lse."""
    b, hq, hkv, sq, skv, d = 3, 8, 2, 24, 24, 16
    q, k, v, dout = map(torch.from_numpy,
                        _qkv(b, hq, hkv, sq, skv, d, seed=3))
    out, lse = _kernel_out(q, k, v, causal=True)
    kw = dict(causal=True, window=0, scale=d ** -0.5, lse=lse)
    whole = attention_backward(q, k, v, out, dout, **kw)
    monkeypatch.setattr(attn_ref, "BACKWARD_TEMP_BYTES",
                        attn_ref.BACKWARD_TEMPS * (hq // hkv) * sq * skv * 4)
    assert len(attn_ref.backward_slices(b, hkv, hq // hkv, sq, skv)) == 6
    sliced = attention_backward(q, k, v, out, dout, **kw)
    for g, w in zip(sliced, whole):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


def test_flash_attention_backward_dispatch():
    """A CPU tensor runs the plain version with the lse; a device with no
    kernel raises."""
    q, k, v, dout = map(torch.from_numpy, _qkv(1, 4, 2, 10, 10, 8, seed=7))
    out, lse = _kernel_out(q, k, v, causal=True)
    kw = dict(causal=True, window=0, scale=8 ** -0.5)
    got = attn_ops.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    want = attention_backward(q, k, v, out, dout, lse=lse, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    meta = [t.to("meta") for t in (q, k, v, out, lse, dout)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attn_ops.flash_attention_backward(*meta, **kw)


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, 0, 12, 12), (False, 0, 6, 12), (True, 4, 12, 12),
    (True, 0, 12, 5)])
def test_flash_attention_function_end_to_end(monkeypatch, causal, window,
                                             sq, skv):
    """`FlashAttention` with the forward and backward kernels swapped for
    their plain versions (the forward saving the plain lse): its
    gradients equal autograd of the plain version (the rows with no key
    left out), the backward reads the saved lse, and a dO of stride 0
    (the gradient of ``.sum()``) is made contiguous first."""
    seen = []

    def forward(q, k, v, *, causal, window, return_lse):
        assert return_lse and not torch.is_grad_enabled()
        return _kernel_out(q, k, v, causal=causal, window=window)

    def backward(q, k, v, out, lse, dout, **kw):
        seen.append((lse, dout.stride()))
        return attention_backward(q, k, v, out, dout, lse=lse, **kw)
    monkeypatch.setattr(attn_ops, "flash_attention_cuda", forward)
    monkeypatch.setattr(attn_ops, "flash_attention_backward", backward)
    q, k, v, _ = map(torch.from_numpy, _qkv(2, 4, 2, sq, skv, 8, seed=sq))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn_ops.FlashAttention.apply(*leaves, causal, window)
    got = torch.autograd.grad(out.sum(), leaves)
    nk = max(0, sq - skv) if causal else 0
    plain = [t.clone().requires_grad_(True) for t in (q[:, :, nk:], k, v)]
    want = torch.autograd.grad(
        gqa_ref(*plain, causal=causal, window=window).sum(), plain)
    assert (got[0][:, :, :nk] == 0).all()
    for g, w in zip((got[0][:, :, nk:], *got[1:]), want):
        torch.testing.assert_close(g, w, rtol=BWD_RTOL, atol=BWD_RTOL)
    (lse, stride), = seen
    assert torch.equal(lse, attention_lse_ref(q, k, causal=causal,
                                              window=window))
    assert stride[-1] == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def attention_backward_calls():
    """Records one entry for each backward pass through a block-attention
    call the models make (the name `models.attention` calls): a hook on
    every output that autograd records."""
    from repro_torch.models import attention as attn_mod
    orig = attn_mod.flash_attention
    seen = []

    def wrapped(q, k, v, *, causal=True, window=0):
        out = orig(q, k, v, causal=causal, window=window)
        if out.requires_grad:
            out.register_hook(lambda g: seen.append(tuple(g.shape)))
        return out
    attn_mod.flash_attention = wrapped
    try:
        yield seen
    finally:
        attn_mod.flash_attention = orig


@pytest.mark.parametrize("arch,layers,remat", [
    ("elasticbert12", 2, False), ("qwen3-1.7b", 2, True),
    ("zamba2-1.2b", 4, True), ("seamless-m4t-large-v2", 2, True),
    ("seamless-m4t-large-v2", 2, False)])
def test_train_backward_launches_count_one_step(arch, layers, remat):
    """The backward kernel launches once for each attention call under a
    gradient, with or without remat: `chip_smoke.train_backward_launches`
    against the backward passes one CPU step takes."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=layers,
                              dtype="float32")
    rng = np.random.default_rng(5)
    b, s = 2, 8
    labels = rng.integers(0, cfg.num_classes or cfg.vocab_size,
                          (b,) if cfg.num_classes else (b, s))
    batch = {"labels": torch.from_numpy(labels.astype(np.int32)),
             "tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (b, s)).astype(np.int32))}
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.source_len, cfg.encoder.d_model)).astype(
                np.float32))
    params = build_model(cfg).init(seed=1, device="cpu").requires_grad_(True)
    step = ttrain.make_train_step(build_model(cfg), AdamWConfig(),
                                  remat=remat, total_steps=2, warmup=0)
    with attention_backward_calls() as seen:
        step(params, adamw_init(params), batch)
    assert len(seen) == smoke.train_backward_launches(cfg) > 0


@pytest.mark.parametrize("arch,positions,want", [
    # the encoder over its 4096 frames and the cross-attention of the 32
    # target tokens over them on wgmma; the decoder's 32 x 32 on mma_sync
    ("seamless-m4t-large-v2", 32, {"wgmma": 48, "mma_sync": 24}),
    ("qwen3-1.7b", 64, {"mma_sync": 28}),
    ("zamba2-1.2b", 64, {"mma_sync": 6}),       # the shared block's uses
    ("qwen2-vl-2b", 64, {"mma_sync": 28}),
    ("rwkv6-3b", 64, {}),                       # no attention
])
def test_train_backward_tiles_at_the_training_shapes(arch, positions, want):
    """`chip_smoke.train_backward_tiles`, the backward launches of one
    bf16 training step by tile that the training runs on the card are
    held to: every launch `train_backward_launches` counts, each under
    the tile `attention_backward_tile` picks for its shape."""
    from repro_torch.configs import get_config
    smoke = _chip_smoke()
    cfg = get_config(arch)
    got = smoke.train_backward_tiles(cfg, positions)
    assert got == want
    assert sum(got.values()) == smoke.train_backward_launches(cfg)
