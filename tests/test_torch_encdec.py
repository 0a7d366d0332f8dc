"""Port vs reference: the enc-dec family (seamless-m4t-large-v2: a
bidirectional encoder over an audio stub's ``frames``, a decoder with
causal self-attention, cross-attention and an exit after every layer).

The reference's `encdec.init_params` is bridged into the port, so both
sides compute with the same weights on numpy-seeded frames and target
tokens. float32 smoke config (encoder 2 layers, decoder 3 layers, d 128,
4 heads of 32, layernorm, GELU MLP, vocab 512, 32 source frames);
rtol = atol = 1e-5 for values, exact for preds and cache positions.

* `cross_attn_kv` / `cross_attn_apply` at Sq != Skv, also against the
  reference's other cross form, `attn_prefill(x_kv=)`;
* `init_params` against `abstract_params`; `param_count` of the full
  config equals the reference's;
* `encode`, `cross_kv`, `train_loss` (value and every gradient against
  `jax.value_and_grad`), `prefill` (logits and every cache leaf),
  `init_caches` (CPU and meta) and `decode_step` in its three exit
  modes;
* the port's own pin: a decode step's logits equal `prefill`'s over the
  prefix one token longer;
* the `Model` facade dispatches to `encdec` (``extras={"cross_kv"}``)
  and refuses `forward_exits*` and the masked decode steps with the
  reference's messages; `DecodeRuntime` refuses the family likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models.api import build_model as j_build_model
from repro.serving.decode import DecodeRuntime as JDecodeRuntime
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import flatten
from repro_torch.serving import DecodeRuntime

RTOL = ATOL = 1e-5
LOSS_RTOL = GRAD_RTOL = 1e-4
ARCH = "seamless-m4t-large-v2"
LAYERS = 3
S, T = 5, 3                     # target prefix, decode steps
_CACHE = {}


def _cfgs(dtype="float32"):
    kw = dict(num_layers=LAYERS, dtype=dtype)
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(t_get_smoke_config(ARCH), **kw))


def _bed():
    if not _CACHE:
        cfg, tcfg = _cfgs()
        jp = jed.init_params(cfg, jax.random.PRNGKey(0))
        # non-trivial norms, so every layernorm's scale and shift is read
        rng = np.random.default_rng(12)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a + jnp.asarray(
                rng.normal(0, 0.1, a.shape), a.dtype)
            if path[-1].key in ("scale", "bias") else a, jp)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE.update(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp)
    c = _CACHE
    return c["cfg"], c["tcfg"], c["jp"], c["tp"]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        elif isinstance(v, tuple):
            out.update({f"{prefix}{k}.{i}": x for i, x in enumerate(v)})
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


def _batch(cfg, b, s, seed, labels=False):
    rng = np.random.default_rng(seed)
    out = {"frames": rng.normal(0, 1, (b, cfg.encoder.source_len,
                                       cfg.encoder.d_model)).astype(
                                           np.float32),
           "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    return out


def _both(x):
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


# --------------------------------------------------------- cross-attention

@pytest.mark.parametrize("sq,skv", [(3, 17), (16, 64)])
def test_cross_attention_at_sq_ne_skv(sq, skv):
    p = jattn.init_attention(jax.random.PRNGKey(sq), 64, 4, 4, 16,
                             qkv_bias=False, qk_norm=False, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(skv)
    enc = rng.normal(0, 1, (2, skv, 64)).astype(np.float32)
    x = rng.normal(0, 1, (2, sq, 64)).astype(np.float32)
    jkv = jattn.cross_attn_kv(p, jnp.asarray(enc), num_kv_heads=4,
                              head_dim=16)
    tkv = tattn.cross_attn_kv(tp, torch.from_numpy(enc), num_kv_heads=4,
                              head_dim=16)
    for a, b in zip(tkv, jkv):
        assert_close(a, b)
    want = jattn.cross_attn_apply(p, jnp.asarray(x), jkv, num_heads=4,
                                  num_kv_heads=4, head_dim=16)
    got = tattn.cross_attn_apply(tp, torch.from_numpy(x), tkv, num_heads=4,
                                 num_kv_heads=4, head_dim=16)
    assert got.shape == (2, sq, 64)
    assert_close(got, want)
    # the reference's other cross form, attn_prefill with x_kv (keys and
    # values projected from the encoder rows, no positions), computes the
    # same function as the port's one cross path
    want = jattn.attn_prefill(p, jnp.asarray(x), None, x_kv=jnp.asarray(enc),
                              num_heads=4, num_kv_heads=4, head_dim=16,
                              causal=False)
    assert_close(got, want)
    with pytest.raises(AssertionError):
        tattn.cross_attn_apply(tp, torch.from_numpy(x), tkv, num_heads=4,
                               num_kv_heads=2, head_dim=16)


# -------------------------------------------------------------- parameters

def test_init_params_tree_matches_reference():
    cfg, tcfg = _cfgs("bfloat16")
    want = _leaves(jed.abstract_params(cfg))
    got = dict(ted.init_params(tcfg, seed=1, device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert _dtype_name(leaf) == _dtype_name(want[path]), path
    assert got["enc_layers.attn.wq"].shape[0] == cfg.encoder.num_layers
    assert got["dec_layers.cross_attn.wq"].shape[0] == cfg.num_layers


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_param_count_of_the_full_config(arch):
    assert t_get_config(arch).param_count() == get_config(arch).param_count()


# ----------------------------------------------------------------- forward

def test_encode_and_cross_kv_match_reference():
    cfg, tcfg, jp, tp = _bed()
    frames = _batch(cfg, 3, 2, 1)["frames"]
    jenc = jed.encode(jp, cfg, jnp.asarray(frames))
    with torch.no_grad():
        tenc = ted.encode(tp, tcfg, torch.from_numpy(frames))
        tckv = ted.cross_kv(tp, tcfg, tenc)
    assert_close(tenc, jenc)
    jckv = jed.cross_kv(jp, cfg, jenc)
    assert len(tckv) == 2
    for a, b in zip(tckv, jckv):
        assert tuple(a.shape) == b.shape == (LAYERS, 3, cfg.encoder.source_len,
                                             cfg.num_kv_heads,
                                             cfg.resolved_head_dim)
        assert_close(a, b)


def test_train_loss_value_and_grads_match_reference():
    cfg, tcfg, jp, _ = _bed()
    jb, tb = _both(_batch(cfg, 3, 8, 4, labels=True))
    ref, jgrads = jax.value_and_grad(
        lambda p: jed.train_loss(p, cfg, jb, remat=False))(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp.requires_grad_(True)
    loss = ted.train_loss(tp, tcfg, tb, remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=LOSS_RTOL)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad.numpy() for n, p in tp.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        rel = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert rel <= GRAD_RTOL, name
    # the encoder is trained through the cross-attention
    assert np.abs(got["enc_layers.attn.wq"]).max() > 0


def _prefilled(b=4, seed=0, s=S):
    cfg, tcfg, jp, tp = _bed()
    jb, tb = _both(_batch(cfg, b, s, seed))
    jl, jc = jed.prefill(jp, cfg, jb, cache_seq_len=S + T)
    with torch.no_grad():
        tl, tc = ted.prefill(tp, tcfg, tb, cache_seq_len=S + T)
    return jl, jc, tl, tc


def test_prefill_matches_reference():
    jl, jc, tl, tc = _prefilled()
    assert sorted(tc) == ["cross_kv", "self"]
    assert_close(tl, jl)
    assert_tree_close(tc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_tree_matches_reference(dtype):
    cfg, tcfg = _cfgs(dtype)
    want = _leaves(jax.eval_shape(lambda: jed.init_caches(cfg, 2, 11)))
    for device in ("cpu", "meta"):
        got = _leaves(ted.init_caches(tcfg, 2, 11, device=device))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            assert tuple(leaf.shape) == want[path].shape, path
            assert _dtype_name(leaf) == _dtype_name(want[path]), path
            assert leaf.device.type == device
    got = ted.init_caches(tcfg, 2, 11, device="cpu")
    assert (got["self"]["pos"] == -1).all()


@pytest.mark.parametrize("mode", ["split_layer", "all_exits", "neither"])
def test_decode_step_matches_reference(mode):
    cfg, tcfg, jp, tp = _bed()
    jl, jc, tl, tc = _prefilled(seed=2)
    jckv, tckv = jc["cross_kv"], tc["cross_kv"]
    jc, tc = {"self": jc["self"]}, {"self": tc["self"]}
    kw = {"split_layer": dict(split_layer=1), "all_exits":
          dict(all_exits=True), "neither": {}}[mode]
    for t in range(T):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jconf, jpred, jc = jed.decode_step(
            jp, cfg, jc, jckv, jnp.asarray(tok), S + t,
            window_seq_len=S + T, **kw)
        with torch.no_grad():
            tl, tconf, tpred, tc = ted.decode_step(
                tp, tcfg, tc, tckv, torch.from_numpy(tok), S + t,
                window_seq_len=S + T, **kw)
        assert_close(tl, jl)
        assert_tree_close(tc, jc)
        if mode == "neither":
            assert tconf is None and tpred is None
        else:
            assert tuple(tconf.shape) == np.shape(jconf)
            assert_close(tconf, jconf)
            np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_stepwise_equals_teacher_forced():
    """A decode step of token S-1 after a prefill of S-1 tokens gives the
    prefill-of-S logits at its last position, and the same cache tree."""
    cfg, tcfg, _, tp = _bed()
    batch = _batch(cfg, 3, S, 9)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    short = dict(tb, tokens=tb["tokens"][:, :-1])
    with torch.no_grad():
        want, want_c = ted.prefill(tp, tcfg, tb, cache_seq_len=S + T)
        _, caches = ted.prefill(tp, tcfg, short, cache_seq_len=S + T)
        got, _, _, got_c = ted.decode_step(tp, tcfg, caches,
                                           caches["cross_kv"],
                                           tb["tokens"][:, -1], S - 1,
                                           all_exits=True,
                                           window_seq_len=S + T)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    for name in ("k", "v"):
        torch.testing.assert_close(got_c["self"][name],
                                   want_c["self"][name], rtol=RTOL,
                                   atol=ATOL)
    assert torch.equal(got_c["self"]["pos"], want_c["self"]["pos"])


# ------------------------------------------------------------------ facade

def _raised(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def test_model_facade_dispatch_and_refusals():
    cfg, tcfg, jp, tp = _bed()
    model, jmodel = build_model(tcfg), j_build_model(cfg)
    assert model.is_encdec and jmodel.is_encdec
    assert not build_model(t_get_smoke_config("qwen2-vl-2b")).is_encdec
    jb, tb = _both(_batch(cfg, 2, S, 5))
    jl, jc = jmodel.prefill(jp, jb, cache_seq_len=S + T)
    with torch.no_grad():
        tl, tc = model.prefill(tp, tb, cache_seq_len=S + T)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        tl2, tconf, _, tc2 = model.decode_step(
            tp, {"self": tc["self"]}, torch.from_numpy(tok), S,
            extras={"cross_kv": tc["cross_kv"]}, all_exits=True,
            window_seq_len=S + T)
        loss = model.train_loss(tp, dict(tb, labels=tb["tokens"]))
    jl2, jconf, _, jc2 = jmodel.decode_step(
        jp, {"self": jc["self"]}, jnp.asarray(tok), S,
        extras={"cross_kv": jc["cross_kv"]}, all_exits=True,
        window_seq_len=S + T)
    assert_close(tl, jl)
    assert_close(tl2, jl2)
    assert_close(tconf, jconf)
    assert_tree_close(tc2, jc2)
    np.testing.assert_allclose(float(loss), float(jmodel.train_loss(
        jp, dict(jb, labels=jb["tokens"]))), rtol=LOSS_RTOL)
    got_caches = model.init_caches(2, 11, device="meta")
    assert tuple(got_caches["self"]["k"].shape) == \
        jax.eval_shape(lambda: jmodel.init_caches(2, 11))["self"]["k"].shape
    init = model.init(seed=3, device="cpu")
    assert "enc_layers" in init and "dec_layers" in init
    for name, call, jcall in (
            ("forward_exits", lambda: model.forward_exits(tp, tb),
             lambda: jmodel.forward_exits(jp, jb)),
            ("decode_step_masked",
             lambda: model.decode_step_masked(tp, tc, None, S, None),
             lambda: jmodel.decode_step_masked(jp, jc, None, S, None)),
            ("decode_step_resume",
             lambda: model.decode_step_resume(tp, tc, None, S, None, None),
             lambda: jmodel.decode_step_resume(jp, jc, None, S, None, None))):
        assert _raised(call, NotImplementedError) == \
            _raised(jcall, NotImplementedError), name
    assert _raised(lambda: model.forward_exits_masked(tp, tb, None),
                   NotImplementedError) == _raised(
        lambda: jmodel.forward_exits(jp, jb), NotImplementedError)


def test_decode_runtime_refuses_the_family():
    cfg, tcfg = _cfgs()
    assert _raised(lambda: DecodeRuntime(tcfg, device="cpu"),
                   NotImplementedError) == _raised(
        lambda: JDecodeRuntime(cfg), NotImplementedError)
    no_enc = dataclasses.replace(tcfg, encoder=None)
    assert _raised(lambda: DecodeRuntime(no_enc, device="cpu"),
                   NotImplementedError) == _raised(
        lambda: JDecodeRuntime(dataclasses.replace(cfg, encoder=None)),
        NotImplementedError)
