"""Port vs reference: the VLM family (qwen2-vl-2b: a decoder over a
vision stub's ``embeds``, rotated by M-RoPE).

The reference's `init_params` is bridged into the port, so both sides
compute with the same weights on numpy-seeded embeddings. float32 smoke
config (d 128, 4 query / 2 KV heads of 32, QKV bias, vocab 512) at 3
layers; rtol = atol = 1e-5 for values, exact for preds and cache
positions.

* `mrope_sections` (hd 128 -> (16, 24, 24)) and `apply_mrope` with three
  different (t, h, w) streams (the reference's pipelines only pass equal
  streams); with equal streams `apply_mrope` == `apply_rope`;
* `attn_prefill` on three streams and `attn_decode` under M-RoPE;
* `init_params` against `abstract_params`, `param_count` at full width;
* `forward_exits`, `forward_exits_masked` (plain and fused), `train_loss`
  (value and every gradient against `jax.value_and_grad`), `prefill`
  and the three decode steps on ``embeds`` batches, decoding from token
  ids and from embed tokens (B, 1, D);
* `EdgeCloudRuntime`'s halves (`edge_fn`, `cloud_fn`, `edge_fn_s`,
  `edge_scan_fn`) against the reference's on ``embeds``;
* `per_step_layer_bytes` gives the family the dense price.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import EdgeCloudRuntime as JRuntime
from repro.serving import kvcache as jkv
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import flatten
from repro_torch.serving import EdgeCloudRuntime
from repro_torch.serving import kvcache as tkv

RTOL = ATOL = 1e-5
LOSS_RTOL = GRAD_RTOL = 1e-4
ARCH = "qwen2-vl-2b"
LAYERS = 3
S, T = 6, 3                     # prompt length, decode steps
_CACHE = {}


def _cfgs(dtype="float32"):
    kw = dict(num_layers=LAYERS, dtype=dtype)
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(t_get_smoke_config(ARCH), **kw))


def _bed():
    if not _CACHE:
        cfg, tcfg = _cfgs()
        jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
        # non-zero QKV biases, so the bias path is exercised
        rng = np.random.default_rng(11)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a + jnp.asarray(
                rng.normal(0, 0.1, a.shape), a.dtype)
            if path[-1].key in ("bq", "bk", "bv") else a, jp)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE.update(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp)
    c = _CACHE
    return c["cfg"], c["tcfg"], c["jp"], c["tp"]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _dtype_name(x):
    return (str(x.dtype).split(".")[1] if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)


def assert_close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def assert_tree_close(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in g:
        a, b = g[path], np.asarray(w[path])
        assert tuple(a.shape) == b.shape, path
        assert _dtype_name(a) == _dtype_name(b), path
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
        else:
            np.testing.assert_allclose(a.float().numpy(), b, rtol=RTOL,
                                       atol=ATOL, err_msg=path)


def _embeds(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model)).astype(np.float32)


def _both(x):
    """A numpy batch as the reference's and the port's."""
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


# ------------------------------------------------------------------ M-RoPE

@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_mrope_sections_match_reference(hd):
    assert tcommon.mrope_sections(hd) == jcommon.mrope_sections(hd)
    assert sum(tcommon.mrope_sections(hd)) == hd // 2
    if hd == 128:
        assert tcommon.mrope_sections(hd) == (16, 24, 24)


@pytest.mark.parametrize("hd", [32, 128])
def test_apply_mrope_three_different_streams(hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(0, 1, (2, 7, 3, hd)).astype(np.float32)
    pos3 = np.stack([rng.integers(0, 50, (2, 7)),
                     rng.integers(0, 9, (2, 7)),
                     rng.integers(0, 13, (2, 7))]).astype(np.int32)
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              1e6)
    assert_close(got, want)
    # each section rotates by its own stream: moving the w stream alone
    # changes only the w section's frequency slots
    moved = pos3.copy()
    moved[2] += 5
    got2 = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved),
                               1e6)
    t, h, w = tcommon.mrope_sections(hd)
    same = torch.isclose(got, got2).all(dim=(0, 1, 2))
    half = hd // 2
    keep = torch.ones(half, dtype=torch.bool)
    keep[t + h:] = False
    assert bool(same[:half][keep].all() and same[half:][keep].all())
    assert not bool(same[:half][~keep].all())


def test_apply_mrope_equal_streams_is_rope():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 5, 4, 32)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 100, (2, 5)).astype(np.int32))
    got = tcommon.apply_mrope(x, pos.expand(3, 2, 5), 1e4)
    assert torch.equal(got, tcommon.apply_rope(x, pos, 1e4))


# --------------------------------------------------------------- attention

def _attn_params(seed, d=64, hq=4, hkv=2, hd=16):
    p = jattn.init_attention(jax.random.PRNGKey(seed), d, hq, hkv, hd,
                             qkv_bias=True, qk_norm=False,
                             dtype=jnp.float32)
    p = {k: v + 0.05 for k, v in p.items()}
    return p, params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def test_attn_prefill_on_three_streams():
    jp, tp = _attn_params(0)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 9, 64)).astype(np.float32)
    pos3 = rng.integers(0, 30, (3, 2, 9)).astype(np.int32)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, causal=True,
              rope_theta=1e4, mrope=True)
    want, (jk, jv) = jattn.attn_prefill(jp, jnp.asarray(x), jnp.asarray(pos3),
                                        return_kv=True, **kw)
    got, (tk, tv) = tattn.attn_prefill(tp, torch.from_numpy(x),
                                       torch.from_numpy(pos3),
                                       return_kv=True, **kw)
    for a, b in ((got, want), (tk, jk), (tv, jv)):
        assert_close(a, b)


def test_attn_decode_under_mrope():
    jp, tp = _attn_params(1)
    rng = np.random.default_rng(6)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1e4,
              mrope=True)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    pos3 = np.broadcast_to(np.arange(5, dtype=np.int32), (3, 2, 5))
    _, (jk, jv) = jattn.attn_prefill(jp, jnp.asarray(x), jnp.asarray(pos3),
                                     return_kv=True, **kw)
    jc = jattn.fill_cache(jattn.init_cache(2, 8, 2, 16, jnp.float32), jk, jv)
    tc = tattn.fill_cache(tattn.init_cache(2, 8, 2, 16, torch.float32),
                          torch.from_numpy(np.array(jk)),
                          torch.from_numpy(np.array(jv)))
    for t in range(3):
        x1 = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
        want, jc = jattn.attn_decode(jp, jnp.asarray(x1), jc, 5 + t, **kw)
        got, tc = tattn.attn_decode(tp, torch.from_numpy(x1), tc, 5 + t, **kw)
        assert_close(got, want)
        assert_tree_close(tc, jc)
    # under M-RoPE with t = h = w the decode equals plain RoPE's
    plain = dict(kw, mrope=False)
    got_plain, _ = tattn.attn_decode(tp, torch.from_numpy(x1), tc, 8, **plain)
    got_m, _ = tattn.attn_decode(tp, torch.from_numpy(x1), tc, 8, **kw)
    torch.testing.assert_close(got_m, got_plain, rtol=0, atol=0)


# -------------------------------------------------------------- parameters

def test_init_params_tree_matches_reference():
    cfg, tcfg = _cfgs("bfloat16")
    want = _leaves(jtf.abstract_params(cfg))
    got = dict(ttf.init_params(tcfg, seed=1, device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert _dtype_name(leaf) == _dtype_name(want[path]), path
    assert "layers.attn.bq" in got
    assert t_get_config(ARCH).param_count() == get_config(ARCH).param_count()


# ------------------------------------------------------- exit observables

def test_forward_exits_on_embeds():
    cfg, tcfg, jp, tp = _bed()
    jb, tb = _both({"embeds": _embeds(cfg, 5, 12, 1)})
    ref = jtf.forward_exits(jp, cfg, jb, conf_backend="pallas_interpret")
    with torch.no_grad():
        got = ttf.forward_exits(tp, tcfg, tb)
    assert_close(got["conf"], ref["conf"])
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(ref["pred"]))
    assert_close(got["hidden"], ref["hidden"])


@pytest.mark.parametrize("fused", [False, True])
def test_forward_exits_masked_on_embeds(fused):
    cfg, tcfg, jp, tp = _bed()
    jb, tb = _both({"embeds": _embeds(cfg, 6, 12, 2)})
    depths = np.arange(6, dtype=np.int32) % LAYERS
    ref = jtf.forward_exits_masked(jp, cfg, jb, jnp.asarray(depths),
                                   window=0, fused_exit=fused)
    with torch.no_grad():
        got = ttf.forward_exits_masked(tp, tcfg, tb, torch.from_numpy(depths),
                                       window=0, fused_exit=fused)
    assert_close(got["conf"], ref["conf"])
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(ref["pred"]))
    assert_close(got["hidden"], ref["hidden"])


def test_train_loss_value_and_grads_on_embeds():
    cfg, tcfg, jp, _ = _bed()
    rng = np.random.default_rng(4)
    batch = {"embeds": _embeds(cfg, 3, 10, 4),
             "labels": rng.integers(0, cfg.vocab_size, (3, 10)).astype(
                 np.int32)}
    jb, tb = _both(batch)
    ref, jgrads = jax.value_and_grad(
        lambda p: jtf.train_loss(p, cfg, jb, remat=False))(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp.requires_grad_(True)
    loss = ttf.train_loss(tp, tcfg, tb, remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=LOSS_RTOL)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    # the embedding table is not read by an embeds batch: no gradient
    # reaches it (the reference's is exactly 0)
    got = {n: np.zeros(p.shape, np.float32) if p.grad is None
           else p.grad.numpy() for n, p in tp.named_parameters()}
    assert tp["embed"].grad is None
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        rel = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert rel <= GRAD_RTOL, name


# ----------------------------------------------------------------- decode

def _prefilled(b=4, seed=0):
    cfg, tcfg, jp, tp = _bed()
    jb, tb = _both({"embeds": _embeds(cfg, b, S, seed)})
    jl, jc = jtf.prefill(jp, cfg, jb, cache_seq_len=S + T)
    with torch.no_grad():
        tl, tc = ttf.prefill(tp, tcfg, tb, cache_seq_len=S + T)
    return jl, jc, tl, tc


def test_prefill_on_embeds():
    jl, jc, tl, tc = _prefilled()
    assert_close(tl, jl)
    assert_tree_close(tc, jc)


def _next(kind, jl, cfg, b, t):
    """The next decode input on both sides: the argmax token ids, or a
    seeded embed token (B, 1, D)."""
    if kind == "ids":
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    else:
        tok = _embeds(cfg, b, 1, 100 + t)
    return jnp.asarray(tok), torch.from_numpy(tok)


@pytest.mark.parametrize("kind", ["ids", "embeds"])
@pytest.mark.parametrize("mode", ["split_layer", "all_exits", "neither"])
def test_decode_step_on_embeds(mode, kind):
    cfg, tcfg, jp, tp = _bed()
    jl, jc, tl, tc = _prefilled(seed=2)
    kw = {"split_layer": dict(split_layer=1), "all_exits":
          dict(all_exits=True), "neither": {}}[mode]
    for t in range(T):
        jtok, ttok = _next(kind, jl, cfg, 4, t)
        jl, jconf, jpred, jc = jtf.decode_step(
            jp, cfg, jc, jtok, S + t, window_seq_len=S + T, **kw)
        with torch.no_grad():
            tl, tconf, tpred, tc = ttf.decode_step(
                tp, tcfg, tc, ttok, S + t, window_seq_len=S + T, **kw)
        assert_close(tl, jl)
        assert_tree_close(tc, jc)
        if mode == "neither":
            assert tconf is None and tpred is None
        else:
            assert_close(tconf, jconf)
            np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


@pytest.mark.parametrize("kind", ["ids", "embeds"])
def test_decode_step_masked_and_resume_on_embeds(kind):
    cfg, tcfg, jp, tp = _bed()
    jl, jc, tl, tc = _prefilled(seed=3)
    steps = np.asarray([[0, 2, 1, 2], [2, 0, 1, 1]], np.int32)
    active = np.asarray([True, False, True, True])
    for t, d in enumerate(steps):
        jtok, ttok = _next(kind, jl, cfg, 4, t)
        jl, jconf, jpred, jh, jc2 = jtf.decode_step_masked(
            jp, cfg, jc, jtok, S + t, jnp.asarray(d), window_seq_len=S + T)
        with torch.no_grad():
            tl, tconf, tpred, th, tc2 = ttf.decode_step_masked(
                tp, tcfg, tc, ttok, S + t, torch.from_numpy(d),
                window_seq_len=S + T)
        assert_close(tl, jl)
        assert_close(tconf, jconf)
        assert_close(th, jh)
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
        assert_tree_close(tc2, jc2)
        jl, jc = jtf.decode_step_resume(jp, cfg, jc2, jh, S + t,
                                        jnp.asarray(d), jnp.asarray(active),
                                        window_seq_len=S + T)
        with torch.no_grad():
            tl, tc = ttf.decode_step_resume(
                tp, tcfg, tc2, th, S + t, torch.from_numpy(d),
                torch.from_numpy(active), window_seq_len=S + T)
        assert_close(tl, jl)
        assert_tree_close(tc, jc)


# ----------------------------------------------------------------- serving

@pytest.mark.parametrize("fused", [False, True])
def test_edge_cloud_runtime_halves_on_embeds(fused):
    cfg, tcfg, jp, tp = _bed()
    jrt = JRuntime(cfg, fused_exit=fused)
    trt = EdgeCloudRuntime(tcfg, device="cpu", fused_exit=fused)
    jb, _ = _both({"embeds": _embeds(cfg, 4, 8, 7)})
    nb = {"embeds": _embeds(cfg, 4, 8, 7)}          # numpy, as served
    with torch.no_grad():
        for depth in range(LAYERS):
            jc, jpred, jh = jrt.edge_fn(jp, jb, jnp.int32(depth))
            tc, tpred, th = trt.edge_fn(tp, nb, depth)
            assert_close(tc, jc)
            np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
            assert_close(th, jh)
            jcl, jpl = jrt.cloud_fn(jp, jh, jnp.int32(depth))
            tcl, tpl = trt.cloud_fn(tp, th, depth)
            assert_close(tcl, jcl)
            np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
            js = jrt.edge_fn_s(jp, jb, jnp.int32(depth))
            ts = trt.edge_fn_s(tp, nb, depth)
            # rows <= depth are what serving reads
            assert_close(ts[0][:depth + 1], js[0][:depth + 1])
            np.testing.assert_array_equal(ts[1][:depth + 1].numpy(),
                                          np.asarray(js[1])[:depth + 1])
        depths = np.asarray([2, 0, 1, 2], np.int32)
        jsc = jrt.edge_scan_fn(jp, jb, jnp.asarray(depths))
        tsc = trt.edge_scan_fn(tp, nb, depths)
    assert_close(tsc[0], jsc[0])
    np.testing.assert_array_equal(tsc[1].numpy(), np.asarray(jsc[1]))
    assert_close(tsc[2], jsc[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_accounting_prices_the_dense_cache(dtype):
    cfg, tcfg = _cfgs(dtype)
    np.testing.assert_array_equal(tkv.per_step_layer_bytes(tcfg),
                                  jkv.per_step_layer_bytes(cfg))
    np.testing.assert_array_equal(
        tkv.per_step_layer_bytes(t_get_config(ARCH)),
        jkv.per_step_layer_bytes(get_config(ARCH)))
