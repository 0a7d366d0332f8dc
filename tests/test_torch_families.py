"""Port vs reference: the hybrid (Zamba2) and MoE (phi3.5-moe, mixtral)
families of the decoder stack, and the dense configs the port registers.

The reference's `init_params` is bridged into the port, so both sides
compute with the same weights on numpy-seeded prompts. float32 smoke
configs: zamba2-1.2b (Mamba2 d 128, 4 heads of 64, state 16, chunk 16;
the shared attention + MLP block every k = 2 layers) run at 4 layers, so
two shared-attention occurrences exist (after layers 1 and 3);
phi3.5-moe and mixtral (4 experts, top-2; mixtral's native window
becomes 64) at 3 layers.

* `init_params` leaf paths, shapes and dtypes equal `abstract_params`'
  (``shared_attn``, the (E, D, F) expert stacks, the f32 Mamba2 leaves
  in a bf16 tree); `param_count` equals the reference's at full width;
  `params_from_jax` carries those leaves bit for bit;
* `forward_exits`, `forward_exits_masked` at mixed depths (plain and
  fused exits): conf at 1e-6, preds exactly, hidden at 1e-4;
* `train_loss` value and every gradient leaf against
  `jax.value_and_grad` (the MoE aux loss included);
* `init_caches` (CPU and meta), `prefill` (every cache leaf; the bf16
  tree's dtypes), `decode_step` in its three exit modes,
  `decode_step_masked` at mixed depths (including depths that skip a
  shared-attention occurrence, whose slot must then stay bitwise), and
  `decode_step_resume` with a partial active mask (everything it does
  not advance passes through bitwise), at rtol = atol = 1e-5;
* the edge's shortcut (no layer above the deepest split is run) gives
  the fully masked loop's tree bitwise when a skipped layer holds a
  shared-attention occurrence; the `Model` facade builds and decodes
  both families;
* `per_step_layer_bytes` and `offload_scale_vec` equal the reference's,
  and `DecodeCacheManager` keeps its ledgers over the hybrid's tree;
* granite-3-2b, qwen1.5-32b (QKV bias, MHA) and deepseek-coder-33b at
  smoke size: `forward_exits` and a prefill + `decode_step`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import transformer as jtf
from repro.serving import kvcache as jkv
from repro.serving.kvcache import DecodeCacheManager as JManager
from repro.serving.offload_codec import OffloadCodec as JCodec
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import flatten
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.offload_codec import OffloadCodec

RTOL = ATOL = 1e-5
CONF_ATOL = 1e-6
HIDDEN_TOL = 1e-4
LOSS_RTOL = GRAD_RTOL = 1e-4
S, T = 6, 3                     # prompt length, decode steps
LAYERS = {"zamba2-1.2b": 4, "phi3.5-moe-42b-a6.6b": 3, "mixtral-8x22b": 3}
BEDS = sorted(LAYERS)
DENSE = ["granite-3-2b", "qwen1.5-32b", "deepseek-coder-33b"]
_CACHE = {}


def _cfgs(arch, dtype="float32", layers=None):
    kw = dict(num_layers=layers or LAYERS[arch], dtype=dtype)
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(t_get_smoke_config(arch), **kw))


def _bed(arch):
    if arch not in _CACHE:
        cfg, tcfg = _cfgs(arch, layers=LAYERS.get(arch, 2))
        jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE[arch] = cfg, tcfg, jp, tp
    return _CACHE[arch]


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


def assert_tree_close(got, want):
    """Same leaf paths, shapes and dtypes; float leaves within RTOL/ATOL,
    integer leaves exactly."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in g:
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


def _prompts(cfg, b, seed, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _prefilled(arch, b=4, seed=0):
    cfg, tcfg, jp, tp = _bed(arch)
    prompts = _prompts(cfg, b, seed)
    jl, jc = jtf.prefill(jp, cfg, {"tokens": jnp.asarray(prompts)},
                         cache_seq_len=S + T)
    with torch.no_grad():
        tl, tc = ttf.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompts)},
                             cache_seq_len=S + T)
    return jl, jc, tl, tc


# ------------------------------------------------------------ parameters

@pytest.mark.parametrize("arch", BEDS)
def test_init_params_tree_matches_reference(arch):
    """The bf16 smoke tree: paths, shapes and dtypes (the Mamba2 block's
    a_log/dt_bias/d_skip stay float32)."""
    cfg, tcfg = _cfgs(arch, "bfloat16")
    want = _leaves(jax.tree.map(lambda a: a, jtf.abstract_params(cfg)))
    got = dict(ttf.init_params(tcfg, seed=1, device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert _dtype_name(leaf) == _dtype_name(want[path]), path
    if cfg.family == "hybrid":
        assert got["layers.mamba.a_log"].dtype == torch.float32
        assert "shared_attn.attn.wq" in got and "shared_attn.mlp.wg" in got
    else:
        e = cfg.moe.num_experts
        assert got["layers.moe.wi"].shape == (cfg.num_layers, e,
                                              cfg.d_model, cfg.d_ff)
    full = get_config(arch)
    assert t_get_config(arch).param_count() == full.param_count()


@pytest.mark.parametrize("arch", BEDS)
def test_bridge_carries_the_new_leaves(arch):
    """`params_from_jax` on a bf16 tree: the f32 Mamba2 leaves inside it,
    ``shared_attn`` and the (L, E, D, F) expert stacks arrive with their
    dtypes and bits."""
    cfg, _ = _cfgs(arch, "bfloat16")
    jp = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(2)))
    tp = dict(params_from_jax(jp, device="cpu").named_parameters())
    want = _leaves(jp)
    assert sorted(tp) == sorted(want)
    for path, leaf in tp.items():
        w = want[path]
        assert _dtype_name(leaf) == _dtype_name(w), path
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy(), w.view(np.int16), path)
        else:
            np.testing.assert_array_equal(leaf.numpy(), w, path)
    keys = ("layers.mamba.dt_bias", "shared_attn.attn.wk") \
        if cfg.family == "hybrid" else ("layers.moe.wo",)
    for key in keys:
        assert key in tp
    if cfg.family == "hybrid":
        assert tp["layers.mamba.dt_bias"].dtype == torch.float32
        assert tp["layers.mamba.w_in"].dtype == torch.bfloat16


def test_init_stacks_each_draw_in_place():
    """The layer stack is filled draw by draw: the same leaves as stacking
    the per-layer draws afterwards."""
    _, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    got = ttf.init_params(tcfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    dt = torch.float32
    ttf.embed_init(gen, tcfg.vocab_size, tcfg.d_model, dt, "cpu")
    want = ttf.stack_trees([ttf._init_layer(tcfg, gen, dt, "cpu")
                       for _ in range(tcfg.num_layers)])
    got_layers = dict(got["layers"].named_parameters())
    assert sorted(got_layers) == sorted(_leaves(want))
    for path, leaf in _leaves(want).items():
        assert torch.equal(got_layers[path], leaf), path


# ------------------------------------------------------- exit observables

@pytest.mark.parametrize("arch", BEDS)
def test_forward_exits_matches_reference(arch):
    cfg, tcfg, jp, tp = _bed(arch)
    toks = _prompts(cfg, 5, 1, s=20)
    ref = jtf.forward_exits(jp, cfg, {"tokens": jnp.asarray(toks)},
                            conf_backend="pallas_interpret")
    with torch.no_grad():
        got = ttf.forward_exits(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(ref["conf"]),
                               rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(ref["pred"]))
    np.testing.assert_allclose(got["hidden"].numpy(),
                               np.asarray(ref["hidden"]), rtol=HIDDEN_TOL,
                               atol=HIDDEN_TOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", BEDS)
def test_forward_exits_masked_matches_reference(arch, fused):
    """Depths that mix every layer; frozen rows still route through the
    MoE layers (competing for capacity), as in the reference."""
    cfg, tcfg, jp, tp = _bed(arch)
    toks = _prompts(cfg, 6, 2, s=20)
    depths = np.arange(6, dtype=np.int32) % cfg.num_layers
    ref = jtf.forward_exits_masked(
        jp, cfg, {"tokens": jnp.asarray(toks)}, jnp.asarray(depths),
        conf_backend="pallas_interpret", window=0, fused_exit=fused)
    with torch.no_grad():
        got = ttf.forward_exits_masked(
            tp, tcfg, {"tokens": torch.from_numpy(toks)},
            torch.from_numpy(depths), window=0, fused_exit=fused)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(ref["conf"]),
                               rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(ref["pred"]))
    np.testing.assert_allclose(got["hidden"].numpy(),
                               np.asarray(ref["hidden"]), rtol=HIDDEN_TOL,
                               atol=HIDDEN_TOL)


@pytest.mark.parametrize("arch", BEDS)
def test_train_loss_value_and_grads_match_reference(arch):
    cfg, tcfg, jp, _ = _bed(arch)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    ref, jgrads = jax.value_and_grad(lambda p: jtf.train_loss(
        p, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=False))(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp.requires_grad_(True)
    loss = ttf.train_loss(tp, tcfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, remat=True)
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
    if cfg.family == "moe":
        # the aux term is live: its router gradient is not the CE's alone
        assert np.abs(got["layers.moe.router"]).max() > 0


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", BEDS)
def test_init_caches_tree_matches_reference(arch, dtype):
    """A hybrid's tree holds L Mamba2 states (f32) and L // k attention
    slots: two subtrees with different leading axes."""
    cfg, tcfg = _cfgs(arch, dtype)
    want = _leaves(jax.eval_shape(lambda: jtf.init_caches(cfg, 2, 11)))
    for device in ("cpu", "meta"):
        got = _leaves(ttf.init_caches(tcfg, 2, 11, device=device))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            assert tuple(leaf.shape) == want[path].shape, path
            assert _dtype_name(leaf) == _dtype_name(want[path]), path
            assert leaf.device.type == device
    if cfg.family == "hybrid":
        got = ttf.init_caches(tcfg, 2, 11, device="meta")
        assert got["ssm"]["ssm"].shape[0] == cfg.num_layers
        assert got["attn"]["k"].shape[0] == cfg.num_layers // 2


@pytest.mark.parametrize("arch", BEDS)
def test_prefill_matches_reference(arch):
    jl, jc, tl, tc = _prefilled(arch)
    assert_close(tl, jl)
    assert_tree_close(tc, jc)


@pytest.mark.parametrize("arch", BEDS)
def test_prefill_cache_tree_in_bfloat16(arch):
    cfg, tcfg = _cfgs(arch, "bfloat16")
    toks = _prompts(cfg, 2, 6)
    jp = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0)))
    want = _leaves(jax.eval_shape(lambda p: jtf.prefill(
        p, cfg, {"tokens": jnp.asarray(toks)}, cache_seq_len=S + T)[1], jp))
    with torch.no_grad():
        logits, got = ttf.prefill(ttf.init_params(tcfg, device="cpu"), tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  cache_seq_len=S + T)
    assert logits.dtype == torch.bfloat16
    got = _leaves(got)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert _dtype_name(leaf) == _dtype_name(want[path]), path


@pytest.mark.parametrize("mode", ["split_layer", "all_exits", "neither"])
@pytest.mark.parametrize("arch", BEDS)
def test_decode_step_matches_reference(arch, mode):
    cfg, tcfg, jp, tp = _bed(arch)
    jl, jc, tl, tc = _prefilled(arch, seed=2)
    kw = {"split_layer": dict(split_layer=1), "all_exits":
          dict(all_exits=True), "neither": {}}[mode]
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for t in range(T):
        jl, jconf, jpred, jc = jtf.decode_step(
            jp, cfg, jc, jnp.asarray(tok), S + t, window_seq_len=S + T, **kw)
        with torch.no_grad():
            tl, tconf, tpred, tc = ttf.decode_step(
                tp, tcfg, tc, torch.from_numpy(tok), S + t,
                window_seq_len=S + T, **kw)
        assert_close(tl, jl)
        assert_tree_close(tc, jc)
        if mode == "neither":
            assert tconf is None and tpred is None
        else:
            assert_close(tconf, jconf)
            np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
        tok = np.array(jnp.argmax(jl, -1), np.int32)


def _edge(arch, depths_by_step, b=4, seed=3):
    """Steps of `decode_step_masked` on both sides from one prefill, each
    exit's argmax at its depth fed back; asserts every output. Returns
    the caches before and after the last step, its hiddens and depths."""
    cfg, tcfg, jp, tp = _bed(arch)
    jl, jc, tl, tc = _prefilled(arch, b=b, seed=seed)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for t, depths in enumerate(depths_by_step):
        prev_tc = tc
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
    return prev_tc, jc, tc, jh, th, depths


def _depth_steps(arch):
    """Mixed depths each step; for zamba2 (occurrences after layers 1
    and 3) depth 0 skips both and depth 2 the second."""
    top = LAYERS[arch] - 1
    return np.asarray([[0, top, 1, 2 % (top + 1)], [top, 0, 0, 1],
                       [2 % (top + 1), 1, top, 0]], np.int32)


def _frozen_entries(cfg, key, i, d):
    """Rows whose depth is below the layer that writes entry ``i`` of
    subtree ``key``."""
    if cfg.family == "hybrid" and key == "attn":
        layer = (i + 1) * cfg.hybrid_attn_every - 1
    else:
        layer = i
    return np.nonzero(d < layer)[0]


@pytest.mark.parametrize("arch", BEDS)
def test_decode_step_masked_at_mixed_depths(arch):
    """Above a row's depth, its cache entries (a hybrid's Mamba2 states
    and shared-attention slots both) keep the previous step's bits."""
    cfg = _bed(arch)[0]
    prev_tc, _, tc, _, _, d = _edge(arch, _depth_steps(arch))
    checked = 0
    for key, sub in tc.items():
        for name, leaf in sub.items():
            for i in range(leaf.shape[0]):
                for b in _frozen_entries(cfg, key, i, d):
                    assert torch.equal(leaf[i, b], prev_tc[key][name][i, b])
                    checked += 1
    assert checked > 0
    if cfg.family == "hybrid":
        assert any(d < 1) and any(d < 3)      # both occurrences skipped


@pytest.mark.parametrize("arch", BEDS)
def test_decode_step_resume_with_partial_active(arch):
    cfg, tcfg, jp, tp = _bed(arch)
    steps = _depth_steps(arch)[:2]
    _, jc, tc, jh, th, d = _edge(arch, steps)
    active = np.asarray([True, True, False, True])
    t = len(steps) - 1
    jl, jc2 = jtf.decode_step_resume(jp, cfg, jc, jh, S + t, jnp.asarray(d),
                                     jnp.asarray(active),
                                     window_seq_len=S + T)
    with torch.no_grad():
        tl, tc2 = ttf.decode_step_resume(
            tp, tcfg, tc, th, S + t, torch.from_numpy(d),
            torch.from_numpy(active), window_seq_len=S + T)
    assert_close(tl, jl)
    assert_tree_close(tc2, jc2)
    moved = 0
    for key, sub in tc2.items():
        for name, leaf in sub.items():
            for i in range(leaf.shape[0]):
                layer = ((i + 1) * cfg.hybrid_attn_every - 1
                         if cfg.family == "hybrid" and key == "attn" else i)
                for b in range(len(active)):
                    same = torch.equal(leaf[i, b], tc[key][name][i, b])
                    if not active[b] or layer <= d[b]:
                        assert same, (key, name, i, b)
                    else:
                        moved += not same
    assert moved > 0


def test_edge_shortcut_equals_the_masked_loop():
    """zamba2 at depths <= 0: the edge runs layer 0 only, skipping both
    shared-attention occurrences; the tree, carry and logits equal those
    of running every layer under its mask, bitwise."""
    _, tcfg, _, tp = _bed("zamba2-1.2b")
    _, _, tl, tc = _prefilled("zamba2-1.2b", seed=9)
    tok = tl.argmax(-1)
    depths = torch.tensor([0, 0, 0, 0])
    with torch.no_grad():
        lg, _, _, h, got = ttf.decode_step_masked(
            tp, tcfg, tc, tok, S, depths, window_seq_len=S + T)
        x = ttf._step_input(tp, tcfg, tok)
        slices = ttf.cache_slices(tc)
        for i in range(tcfg.num_layers):
            x = ttf._decode_layer(tcfg, tp, slices, i, x, S, window=0,
                                  mask=i <= depths)
        want = ttf.restack(slices)
    assert torch.equal(h, x)
    assert torch.equal(lg, ttf._final_logits(tp, tcfg, x))
    g, w = _leaves(got), _leaves(want)
    for path in g:
        assert torch.equal(g[path], w[path]), path


@pytest.mark.parametrize("arch", BEDS)
def test_model_facade_builds_and_decodes(arch):
    """The `Model` facade's prefill and decode step, as the module
    functions give them."""
    cfg, tcfg, jp, tp = _bed(arch)
    jl, jc, _, _ = _prefilled(arch, b=2, seed=8)
    model = build_model(tcfg)
    toks = _prompts(cfg, 2, 8)
    with torch.no_grad():
        tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               cache_seq_len=S + T)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        tl2, _, _, tc2 = model.decode_step(tp, tc, torch.from_numpy(tok), S,
                                           all_exits=True,
                                           window_seq_len=S + T)
    jl2, _, _, jc2 = jtf.decode_step(jp, cfg, jc, jnp.asarray(tok), S,
                                     all_exits=True, window_seq_len=S + T)
    assert_close(tl, jl)
    assert_close(tl2, jl2)
    assert_tree_close(tc2, jc2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", BEDS)
def test_wire_accounting_equals_reference(arch, dtype):
    """A hybrid prices the shared-attention slot only at its k-th layers."""
    cfg, tcfg = _cfgs(arch, dtype)
    want = jkv.per_step_layer_bytes(cfg)
    got = tkv.per_step_layer_bytes(tcfg)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    if cfg.family == "hybrid":
        assert got[1] > got[0] and got[3] == got[1] and got[2] == got[0]
    for kw in (None, dict(quant="int8"), dict(quant="int4", sparsity=0.5)):
        np.testing.assert_array_equal(
            tkv.offload_scale_vec(tcfg, None if kw is None
                                  else OffloadCodec(**kw)),
            jkv.offload_scale_vec(cfg, None if kw is None else JCodec(**kw)))
    full, tfull = get_config(arch), t_get_config(arch)
    np.testing.assert_array_equal(tkv.per_step_layer_bytes(tfull),
                                  jkv.per_step_layer_bytes(full))


def test_cache_manager_on_the_hybrid_tree():
    """`DecodeCacheManager` over zamba2's tree (4 Mamba2 states, 2 shared
    slots): the reference's batch, per-split wire bytes and metering, and
    its residuals on the rows' device."""
    cfg, tcfg, _, _ = _bed("zamba2-1.2b")
    _, jc, _, tc = _prefilled("zamba2-1.2b", b=3, seed=4)
    assert tc["ssm"]["ssm"].shape[0] != tc["attn"]["k"].shape[0]
    tm = tkv.DecodeCacheManager(tcfg, tc, codec=OffloadCodec(
        quant="int8", error_feedback=True))
    jm = JManager(cfg, jc, codec=JCodec(quant="int8", error_feedback=True))
    assert tm.batch == jm.batch == 3
    np.testing.assert_array_equal(tm._slice_cum, jm._slice_cum)
    assert tuple(tm._residual.shape) == jm._residual.shape
    rows, depths = np.asarray([0, 2]), np.asarray([3, 0, 1])
    np.testing.assert_array_equal(tm.meter(rows, depths, 100),
                                  jm.meter(rows, depths, 100))


# -------------------------------------------------- the dense registrations

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_reference(arch):
    """`forward_exits` and a prefill + two `decode_step`s (all exits) of
    the smoke config at 2 layers; the full config equals the
    reference's."""
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    cfg, tcfg, jp, tp = _bed(arch)
    toks = _prompts(cfg, 3, 5)
    ref = jtf.forward_exits(jp, cfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = ttf.forward_exits(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(ref["conf"]),
                               rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(ref["pred"]))
    jl, jc = jtf.prefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                         cache_seq_len=S + 2)
    with torch.no_grad():
        tl, tc = ttf.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             cache_seq_len=S + 2)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for t in range(2):
        jl, jconf, _, jc = jtf.decode_step(jp, cfg, jc, jnp.asarray(tok),
                                           S + t, all_exits=True,
                                           window_seq_len=S + 2)
        with torch.no_grad():
            tl, tconf, _, tc = ttf.decode_step(tp, tcfg, tc,
                                               torch.from_numpy(tok), S + t,
                                               all_exits=True,
                                               window_seq_len=S + 2)
        assert_close(tl, jl)
        assert_close(tconf, jconf)
        assert_tree_close(tc, jc)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
