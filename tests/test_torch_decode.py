"""Port vs reference: autoregressive decode of the model (KV caches, the
one-token attention, `prefill`, `decode_step`, `decode_step_masked`,
`decode_step_resume`, the `Model` facade).

The reference's `init_params` is bridged into the port, so both sides
compute with the same weights on the same numpy-seeded prompts and
tokens. float32 smoke configs of qwen3-1.7b (dense, GQA, qk_norm) and
rwkv6-3b (ssm), cut to 3 layers so that depth masks mix; "qwen3-window"
forces a 4-slot sliding window under a 6-token prompt, so the ring wraps
in the prefill and the window term of the decode mask is live. Logits,
exit confidences and every float cache leaf at rtol = atol = 1e-5;
tokens, preds and ``pos`` exactly; every cache leaf's path, shape and
dtype equal to the reference's.

One leaf is held otherwise in `test_decode_step_matches_reference`: the
rwkv6 WKV state (entries up to ~15 after the prefill) carries float32
round-off from both sides' matmuls that a host's float32 rounding decides,
and both sides sit the same distance (~1.2 float32 ulps of the state's
largest entry, x10) from a float64 reading of the same recurrence. There
each side is held against that float64 witness, within `WKV_ULPS` float32
ulps of the state's largest entry, and the port at most `WITNESS_FACTOR`
times as far from it as the reference; the logits, confidences and the
other leaves stay port vs reference at 1e-5.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model

RTOL = ATOL = 1e-5
# rwkv6's WKV state vs the float64 witness: each side within WKV_ULPS
# float32 ulps of the witness state's largest |entry| (both sit at ~12 on
# the test's inputs), the port at most WITNESS_FACTOR times as far off as
# the reference (the chip smoke's bound for the card against the CPU)
WKV_ULPS = 32
WITNESS_FACTOR = 2.0
LAYERS = 3
S, T = 6, 3                    # prompt length, decode steps
BEDS = ["qwen3-1.7b", "rwkv6-3b", "qwen3-window"]
_CACHE = {}


def _cfgs(bed, dtype="float32"):
    arch = "qwen3-1.7b" if bed == "qwen3-window" else bed
    extra = dict(num_layers=LAYERS, dtype=dtype)
    if bed == "qwen3-window":
        extra["sliding_window_override"] = 4
    return (dataclasses.replace(get_smoke_config(arch), **extra),
            dataclasses.replace(t_get_smoke_config(arch), **extra))


def _bed(bed):
    if bed not in _CACHE:
        cfg, tcfg = _cfgs(bed)
        jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE[bed] = cfg, tcfg, jp, tp
    return _CACHE[bed]


def _dtype_name(x):
    return (str(x.dtype).split(".")[1] if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_tree_close(got, want, skip=()):
    """Same leaf paths, shapes and dtypes; float leaves within RTOL/ATOL
    (but the paths in ``skip``, which the caller holds otherwise), integer
    leaves exactly."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in g:
        if path in skip:
            continue
        a, b = g[path], np.asarray(w[path])
        assert tuple(a.shape) == b.shape, path
        assert _dtype_name(a) == _dtype_name(b), path
        a = a.float().numpy() if a.is_floating_point() else a.numpy()
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b.astype(np.float32), rtol=RTOL,
                                       atol=ATOL, err_msg=path)


def assert_close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _prompts(cfg, b, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, S)).astype(np.int32)


def _prefilled(bed, b=4, seed=0):
    """Both sides' prefill of the same prompts, cache sized for S + T."""
    cfg, tcfg, jp, tp = _bed(bed)
    prompts = _prompts(cfg, b, seed)
    jl, jc = jtf.prefill(jp, cfg, {"tokens": jnp.asarray(prompts)},
                         cache_seq_len=S + T)
    with torch.no_grad():
        tl, tc = ttf.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompts)},
                             cache_seq_len=S + T)
    return jl, jc, tl, tc


@contextlib.contextmanager
def _float64_kept():
    """``Tensor.float()`` returns float64 tensors unchanged: the port's
    plain versions cast to float32 on purpose (the reference's dtype
    steps), so inside this context a float64 tree runs every step of the
    recurrence in float64."""
    orig = torch.Tensor.float

    def keep(self, *a, **k):
        return self if self.dtype == torch.float64 else orig(self, *a, **k)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = orig


def assert_wkv_witnessed(got, want, witness):
    """The port's (``got``) and the reference's (``want``) float32 WKV
    states against the float64 ``witness``: each within WKV_ULPS float32
    ulps of the witness's largest |entry|, the port at most
    WITNESS_FACTOR times as far off as the reference."""
    w = witness.numpy()
    assert w.dtype == np.float64
    port = np.abs(got.double().numpy() - w).max()
    ref = np.abs(np.asarray(want, np.float64) - w).max()
    bound = WKV_ULPS * np.finfo(np.float32).eps * np.abs(w).max()
    assert ref <= bound, (ref, bound)
    assert port <= bound, (port, bound)
    assert port <= WITNESS_FACTOR * ref, (port, ref)


# ----------------------------------------------------------- cache modules

@pytest.mark.parametrize("window", [0, 3])
def test_cache_fill_and_attn_decode(window):
    """`init_cache`, `fill_cache` at a start offset that wraps the ring,
    and three `attn_decode` steps (GQA, qk_norm, RoPE at theta 1e6) with
    and without the window term."""
    cfg, tcfg, jp, tp = _bed("qwen3-1.7b")
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    lp_t = ttf.layer_params(tp["layers"], 0)["attn"]
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    rng = np.random.default_rng(1)
    b, w, s, start = 2, 5, 4, 3               # slots 3, 4, 0, 1
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    jc = jattn.fill_cache(jattn.init_cache(b, w, hkv, hd, jnp.float32),
                          jnp.asarray(k), jnp.asarray(v), start=start)
    empty = tattn.init_cache(b, w, hkv, hd, torch.float32, device="cpu")
    tc = tattn.fill_cache(empty, torch.from_numpy(k), torch.from_numpy(v),
                          start=start)
    assert (empty["pos"] == -1).all() and (empty["k"] == 0).all()
    assert_tree_close(tc, jc)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=hkv, head_dim=hd,
              window=window, rope_theta=cfg.rope_theta, qk_norm=True)
    for step in range(3):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jattn.attn_decode(lp_j, jnp.asarray(x), jc, start + s + step,
                                   **kw)
        to, tc = tattn.attn_decode(lp_t, torch.from_numpy(x), tc,
                                   start + s + step, **kw)
        assert_close(to, jo)
        assert_tree_close(tc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_init_caches_tree_matches_reference(arch, dtype):
    """Leaf paths, shapes and dtypes of `init_caches`, on the CPU and on
    the meta device: k/v in the model dtype, pos int32, recurrent states
    float32."""
    cfg, tcfg = _cfgs(arch, dtype)
    want = jax.eval_shape(lambda: jtf.init_caches(cfg, 2, 11))
    for device in ("cpu", "meta"):
        got = ttf.init_caches(tcfg, 2, 11, device=device)
        g, w = _leaves(got), _leaves(want)
        assert sorted(g) == sorted(w)
        for path in g:
            assert tuple(g[path].shape) == w[path].shape, path
            assert _dtype_name(g[path]) == _dtype_name(w[path]), path
            assert g[path].device.type == device
    real = _leaves(ttf.init_caches(tcfg, 2, 11, device="cpu"))
    ref = _leaves(jtf.init_caches(cfg, 2, 11))
    for path, leaf in real.items():
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(ref[path], np.float32))


# ------------------------------------------------------------- model steps

@pytest.mark.parametrize("bed", BEDS)
def test_prefill_matches_reference(bed):
    """Final logits and every cache leaf (dtypes included: an ssm layer's
    token-shift rows come out in the model dtype)."""
    jl, jc, tl, tc = _prefilled(bed)
    assert_close(tl, jl)
    assert_tree_close(tc, jc)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_prefill_cache_tree_in_bfloat16(arch):
    """In bfloat16 the prefill's tree keeps the reference's dtypes leaf
    by leaf: an ssm layer's token-shift rows in the model dtype (not the
    float32 of `init_caches`), its WKV state float32, k/v bfloat16."""
    cfg, tcfg = _cfgs(arch, "bfloat16")
    toks = _prompts(cfg, 2, 6)
    jp = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0)))
    want = jax.eval_shape(lambda p: jtf.prefill(
        p, cfg, {"tokens": jnp.asarray(toks)}, cache_seq_len=S + T)[1], jp)
    with torch.no_grad():
        logits, got = ttf.prefill(ttf.init_params(tcfg, device="cpu"), tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  cache_seq_len=S + T)
    assert logits.dtype == torch.bfloat16
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in g:
        assert tuple(g[path].shape) == w[path].shape, path
        assert _dtype_name(g[path]) == _dtype_name(w[path]), path


@pytest.mark.parametrize("mode", ["split_layer", "all_exits", "neither"])
@pytest.mark.parametrize("bed", BEDS)
def test_decode_step_matches_reference(bed, mode):
    """T greedy steps of `decode_step` in each exit mode: logits, conf,
    pred and the cache tree after every step. rwkv6's WKV state is held
    against a float64 run of the port on the same weights and tokens
    (`assert_wkv_witnessed`); every other output port vs reference."""
    cfg, tcfg, jp, tp = _bed(bed)
    jl, jc, tl, tc = _prefilled(bed, seed=2)
    kw = {"split_layer": dict(split_layer=1), "all_exits":
          dict(all_exits=True), "neither": {}}[mode]
    witnessed = bed == "rwkv6-3b"
    skip = ("ssm.wkv",) if witnessed else ()
    if witnessed:
        tp64 = ttf.ParamTree(ttf.map_tree(lambda a: a.double(), tp))
        with torch.no_grad(), _float64_kept():
            _, wc = ttf.prefill(tp64, tcfg, {"tokens": torch.from_numpy(
                _prompts(cfg, 4, 2))}, cache_seq_len=S + T)
        assert_wkv_witnessed(tc["ssm"]["wkv"], jc["ssm"]["wkv"],
                             wc["ssm"]["wkv"])
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for t in range(T):
        jl, jconf, jpred, jc = jtf.decode_step(
            jp, cfg, jc, jnp.asarray(tok), S + t, window_seq_len=S + T, **kw)
        with torch.no_grad():
            tl, tconf, tpred, tc = ttf.decode_step(
                tp, tcfg, tc, torch.from_numpy(tok), S + t,
                window_seq_len=S + T, **kw)
            if witnessed:
                with _float64_kept():
                    _, _, _, wc = ttf.decode_step(
                        tp64, tcfg, wc, torch.from_numpy(tok), S + t,
                        window_seq_len=S + T, **kw)
                assert_wkv_witnessed(tc["ssm"]["wkv"], jc["ssm"]["wkv"],
                                     wc["ssm"]["wkv"])
        assert_close(tl, jl)
        assert_tree_close(tc, jc, skip=skip)
        if mode == "neither":
            assert tconf is None and tpred is None
        else:
            assert tconf.shape == jconf.shape
            assert_close(tconf, jconf)
            np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)


def _edge(bed, depths_by_step, b=4, seed=3):
    """T steps of `decode_step_masked` on both sides from the same
    prefill, feeding each exit's argmax at its depth (the final head's at
    L-1) as the next token; asserts every output as it goes. Returns the
    last step's caches, hiddens and the depths of the last step."""
    cfg, tcfg, jp, tp = _bed(bed)
    jl, jc, tl, tc = _prefilled(bed, b=b, seed=seed)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for t, depths in enumerate(depths_by_step):
        prev_jc, prev_tc = jc, tc
        jl, jconf, jpred, jh, jc = jtf.decode_step_masked(
            jp, cfg, jc, jnp.asarray(tok), S + t, jnp.asarray(depths),
            window_seq_len=S + T)
        with torch.no_grad():
            tl, tconf, tpred, th, tc = ttf.decode_step_masked(
                tp, tcfg, tc, torch.from_numpy(tok), S + t,
                torch.from_numpy(depths), window_seq_len=S + T)
        assert_close(tl, jl)
        assert_close(tconf, jconf)
        assert_close(th, jh)
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
        assert_tree_close(tc, jc)
        fin = np.array(jnp.argmax(jl, -1), np.int32)
        tok = np.where(depths == cfg.num_layers - 1, fin,
                       np.asarray(jpred)[depths, np.arange(b)]).astype(
                           np.int32)
    return prev_jc, prev_tc, jc, tc, jh, th, depths


@pytest.mark.parametrize("bed", BEDS)
def test_decode_step_masked_at_mixed_depths(bed):
    """Every step mixes depths 0..L-1 across the batch; a layer above a
    row's depth leaves its slot unwritten and its state frozen, and the
    next step reads the holes through the pos mask."""
    depths = np.asarray([[0, 2, 1, 2], [2, 0, 0, 1], [1, 1, 2, 0]],
                        np.int32)
    prev_jc, prev_tc, _, tc, _, _, d = _edge(bed, depths)
    # rows above their depth keep the previous step's leaf bitwise
    key = "ssm" if bed == "rwkv6-3b" else "attn"
    for name, leaf in tc[key].items():
        for i in range(LAYERS):
            for b in np.nonzero(d < i)[0]:
                assert torch.equal(leaf[i, b], prev_tc[key][name][i, b])


@pytest.mark.parametrize("bed", BEDS)
def test_decode_step_resume_with_partial_active(bed):
    """The cloud resume after a mixed-depth edge step, half the rows
    active: logits and the cache tree equal the reference's, and the
    tree equals its input bitwise at every inactive row and at every
    layer <= a row's depth."""
    cfg, tcfg, jp, tp = _bed(bed)
    depths = np.asarray([[2, 1, 0, 2], [0, 1, 0, 1]], np.int32)
    _, _, jc, tc, jh, th, d = _edge(bed, depths)
    active = np.asarray([True, True, False, True])
    t = len(depths) - 1
    jl, jc2 = jtf.decode_step_resume(jp, cfg, jc, jh, S + t, jnp.asarray(d),
                                     jnp.asarray(active),
                                     window_seq_len=S + T)
    with torch.no_grad():
        tl, tc2 = ttf.decode_step_resume(
            tp, tcfg, tc, th, S + t, torch.from_numpy(d),
            torch.from_numpy(active), window_seq_len=S + T)
    assert_close(tl, jl)
    assert_tree_close(tc2, jc2)
    key = "ssm" if bed == "rwkv6-3b" else "attn"
    moved = 0
    for name, leaf in tc2[key].items():
        for i in range(LAYERS):
            for b in range(len(active)):
                same = torch.equal(leaf[i, b], tc[key][name][i, b])
                if not active[b] or i <= d[b]:
                    assert same, (name, i, b)
                else:
                    moved += not same
    assert moved > 0


def test_layers_no_row_needs_are_not_run(monkeypatch):
    """The edge runs no layer above the batch's deepest split and the
    cloud none at or below its shallowest active one (their results are
    the masked ones; the tests above hold those to the reference)."""
    _, tcfg, _, tp = _bed("qwen3-1.7b")
    _, _, tl, tc = _prefilled("qwen3-1.7b", seed=7)
    calls = []
    real = ttf._layer_decode
    monkeypatch.setattr(ttf, "_layer_decode", lambda cfg, lp, *a, **k: (
        calls.append(lp), real(cfg, lp, *a, **k))[1])
    depths = torch.tensor([0, 1, 0, 1])
    with torch.no_grad():
        *_, h, ec = ttf.decode_step_masked(tp, tcfg, tc, tl.argmax(-1), S,
                                           depths, window_seq_len=S + T)
        assert len(calls) == 2
        ttf.decode_step_resume(tp, tcfg, ec, h, S, depths,
                               torch.tensor([False, True, False, True]),
                               window_seq_len=S + T)
        assert len(calls) == 2 + LAYERS - 2
        ttf.decode_step_resume(tp, tcfg, ec, h, S, depths,
                               torch.zeros(4, dtype=torch.bool),
                               window_seq_len=S + T)
    assert len(calls) == LAYERS


def test_model_facade_decode():
    """`Model.prefill`/`init_caches`/`decode_step*` are the transformer
    functions."""
    _, tcfg, _, tp = _bed("qwen3-1.7b")
    model = build_model(tcfg)
    toks = torch.from_numpy(_prompts(tcfg, 2, 5))
    with torch.no_grad():
        lg, caches = model.prefill(tp, {"tokens": toks}, cache_seq_len=S + 1)
        lg2, c2 = ttf.prefill(tp, tcfg, {"tokens": toks}, cache_seq_len=S + 1)
        assert torch.equal(lg, lg2)
        empty = model.init_caches(2, S + 1, device="cpu")
        assert empty["attn"]["k"].shape == caches["attn"]["k"].shape
        tok = lg.argmax(-1)
        a = model.decode_step(tp, caches, tok, S, all_exits=True)
        b = ttf.decode_step(tp, tcfg, caches, tok, S, all_exits=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        depths = torch.tensor([0, LAYERS - 1])
        m = model.decode_step_masked(tp, caches, tok, S, depths)
        r = model.decode_step_resume(tp, m[4], m[3], S, depths,
                                     torch.tensor([True, False]))
    assert torch.equal(m[0][1], a[0][1])
    assert r[0].shape == a[0].shape
