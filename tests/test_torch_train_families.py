"""Port vs reference: training the dense-LM, hybrid, MoE, VLM and enc-dec
families, and attention's gradient over slices.

* `make_train_step` (remat on, as the card trains) takes three steps from
  the bridged reference init and equals the reference's jitted step
  (remat off; the same arithmetic): losses at STEP_RTOL, gradient norms at
  GRAD_RTOL, and after the steps every parameter element whose step-0
  gradient exceeds GRAD_FLOOR within PARAM_ATOL. float32 smoke configs:
  qwen3-1.7b (dense LM, qk_norm, GQA), zamba2-1.2b at 4 layers (two
  shared-block occurrences), phi3.5-moe (4 experts top-2, the aux loss),
  qwen2-vl-2b over ``embeds`` (M-RoPE, QKV bias) and
  seamless-m4t-large-v2 (2 encoder + 2 decoder layers, cross-attention).
* `chip_smoke.train_attention_launches` against the block-attention calls
  counted in one such step of each family, with remat on and off (the
  card's launch check of its training phase reads that function).
* `attention_backward` over (batch, KV-group) slices, the budget
  monkeypatched small: equal to the whole call (rtol 1e-6) and to
  `jax.vjp` of the reference's plain attention, at causal GQA, a sliding
  window and Sq < Skv; `backward_slices` tiles the grid and keeps every
  slice within the budget.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.flash_attention.ref import gqa_ref as j_gqa_ref
from repro.launch import train as jtrain
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro.models.api import build_model as j_build_model
from repro.optim import adamw_init as j_adamw_init
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.launch import train as ttrain
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig, flatten

STEP_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
GRAD_FLOOR = 1e-6
SLICE_RTOL = 1e-6
VJP_RTOL = 1e-5            # attention_backward: a handful of f32 products
STEPS = 3

ROOT = Path(__file__).resolve().parents[1]

FAMILIES = {
    # family: (arch, layers)
    "dense-lm": ("qwen3-1.7b", 2),
    "hybrid": ("zamba2-1.2b", 4),
    "moe": ("phi3.5-moe-42b-a6.6b", 2),
    "vlm": ("qwen2-vl-2b", 2),
    "encdec": ("seamless-m4t-large-v2", 2),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(family):
    arch, layers = FAMILIES[family]
    return tuple(dataclasses.replace(get(arch), num_layers=layers,
                                     dtype="float32")
                 for get in (get_smoke_config, t_get_smoke_config))


def _init(cfg):
    if cfg.encoder is not None:
        return jed.init_params(cfg, jax.random.PRNGKey(0))
    return jtf.init_params(cfg, jax.random.PRNGKey(0))


def _batch(cfg, seed, b=3, s=12):
    """A numpy batch of the family: tokens (an ``embeds`` batch for the
    VLM, ``frames`` beside the target tokens for the enc-dec model) and
    next-token labels."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.encoder is not None:
        out["frames"] = rng.normal(0, 1, (b, cfg.encoder.source_len,
                                          cfg.encoder.d_model)).astype(
            np.float32)
    return out


def _grads(params):
    return {n: np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy().copy() for n, p in params.named_parameters()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_steps_match_reference(family):
    cfg, tcfg = _cfgs(family)
    jp = _init(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         device="cpu").requires_grad_(True)
    kw = dict(total_steps=STEPS + 2, warmup=1)
    jstep = jax.jit(jtrain.make_train_step(j_build_model(cfg), JAdamWConfig(),
                                           remat=False, **kw))
    tstep = ttrain.make_train_step(build_model(tcfg), AdamWConfig(),
                                   remat=True, **kw)
    jstate, tstate = j_adamw_init(jp), adamw_init(tp)
    grad0 = None
    for i in range(STEPS):
        batch = _batch(cfg, 20 + i)
        jp, jstate, jinfo = jstep(
            jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tinfo = tstep(tp, tstate, {k: torch.from_numpy(v)
                                               for k, v in batch.items()})
        np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(float(tinfo["gnorm"]),
                                   float(jinfo["gnorm"]), rtol=GRAD_RTOL)
        if grad0 is None:
            grad0 = _grads(tp)
    assert tstate["count"] == int(jstate["count"]) == STEPS
    want = flatten(jax.tree.map(np.asarray, jp))
    assert sorted(want) == sorted(grad0)
    held = 0
    for name, p in tp.named_parameters():
        big = np.abs(grad0[name]) > GRAD_FLOOR
        if big.any():
            diff = np.abs(p.detach().numpy() - np.asarray(want[name]))
            assert diff[big].max() <= PARAM_ATOL, name
            held += int(big.sum())
    assert held > 0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_attention_launches_count_one_step(family, remat):
    """The pure launch model of a training step against the attention
    calls one `make_train_step` step makes on the CPU (where the plain
    version runs in the kernel's place, one call for each launch the card
    would make; remat's recompute calls it again)."""
    smoke = _chip_smoke()
    _, tcfg = _cfgs(family)
    params = build_model(tcfg).init(seed=1, device="cpu").requires_grad_(True)
    step = ttrain.make_train_step(build_model(tcfg), AdamWConfig(),
                                  remat=remat, total_steps=2, warmup=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 5).items()}
    with smoke.attention_calls() as seen:
        step(params, adamw_init(params), batch)
    assert len(seen) == smoke.train_attention_launches(tcfg, remat)
    kinds = {(causal, sq == skv) for causal, sq, skv in seen}
    if tcfg.encoder is not None:     # encoder, causal self, cross
        assert kinds == {(False, True), (True, True), (False, False)}
    else:
        assert kinds == {(True, True)}


def test_train_attention_launches_model():
    smoke = _chip_smoke()
    from repro_torch.configs import get_config
    want = {"qwen3-1.7b": (28, 56), "zamba2-1.2b": (6, 12),
            "phi3.5-moe-42b-a6.6b": (32, 64), "qwen2-vl-2b": (28, 56),
            "seamless-m4t-large-v2": (24 + 48, 24 + 96), "rwkv6-3b": (0, 0),
            "elasticbert12": (12, 24)}
    for arch, (plain, remat) in want.items():
        cfg = get_config(arch)
        assert smoke.train_attention_launches(cfg, False) == plain, arch
        assert smoke.train_attention_launches(cfg, True) == remat, arch


# ------------------------------------------- attention's gradient, sliced

SLICE_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, budget in KV groups
    (3, 8, 2, 24, 24, 16, True, 0, 1),      # causal GQA, a group a slice
    (3, 8, 2, 24, 24, 16, True, 0, 3),      # causal GQA, whole samples
    (2, 4, 4, 40, 40, 32, True, 8, 3),      # sliding window, group runs
    (2, 6, 2, 7, 30, 16, True, 0, 1),       # GQA, suffix queries
    (2, 4, 4, 9, 33, 16, False, 0, 5),      # Sq < Skv, bidirectional
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,groups",
                         SLICE_CASES)
def test_sliced_attention_backward(monkeypatch, b, hq, hkv, sq, skv, d,
                                   causal, window, groups):
    rng = np.random.default_rng(sq * skv + groups)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    dout = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    out = attn_ref.gqa_ref(tq, tk, tv, **kw)
    args = (tq, tk, tv, out, tdout)
    whole = attn_ref.attention_backward(*args, scale=d ** -0.5, **kw)
    rep = hq // hkv
    budget = groups * attn_ref.BACKWARD_TEMPS * rep * sq * skv * 4
    monkeypatch.setattr(attn_ref, "BACKWARD_TEMP_BYTES", budget)
    slices = attn_ref.backward_slices(b, hkv, rep, sq, skv)
    assert len(slices) > 1
    calls = []
    orig = attn_ref._backward_slice

    def counted(q, *a):
        calls.append(q.shape)
        return orig(q, *a)
    monkeypatch.setattr(attn_ref, "_backward_slice", counted)
    sliced = attn_ref.attention_backward(*args, scale=d ** -0.5, **kw)
    assert len(calls) == len(slices)
    for shape in calls:   # each slice's P and dS within the budget
        assert attn_ref.BACKWARD_TEMPS * shape[0] * shape[1] * sq * skv * 4 \
            <= budget
    _, vjp = jax.vjp(lambda *x: j_gqa_ref(*x, **kw), *map(jnp.asarray,
                                                          (q, k, v)))
    for got, w, wj in zip(sliced, whole, vjp(jnp.asarray(dout))):
        assert got.shape == w.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, w, rtol=SLICE_RTOL, atol=0)
        err = np.abs(got.numpy() - np.asarray(wj)).max() / np.abs(
            np.asarray(wj)).max()
        assert err <= VJP_RTOL


@pytest.mark.parametrize("b,hkv,rep,sq,skv", [
    (8, 16, 1, 4096, 4096), (8, 16, 1, 32, 4096), (16, 8, 2, 64, 64),
    (3, 5, 3, 700, 900), (1, 2, 6, 20000, 20000)])
def test_backward_slices_tile_the_grid_within_the_budget(b, hkv, rep, sq,
                                                         skv):
    slices = attn_ref.backward_slices(b, hkv, rep, sq, skv)
    seen = np.zeros((b, hkv), np.int64)
    for bs, gs in slices:
        seen[bs, gs] += 1
        groups = (bs.stop - bs.start) * (gs.stop - gs.start)
        temps = attn_ref.BACKWARD_TEMPS * groups * rep * sq * skv * 4
        assert temps <= attn_ref.BACKWARD_TEMP_BYTES or groups == 1
    assert (seen == 1).all()
    if b == 8 and sq == 4096:      # seamless's encoder: one sample a slice
        assert slices == [(slice(i, i + 1), slice(0, 16)) for i in range(8)]
    if sq * skv <= 4096 * 64:      # seamless's cross and the LMs: one call
        assert len(slices) == 1
