"""Port vs reference: training (cross-entropy, `train_loss`, the train
step, `train_classifier`, `exit_accuracy`, `build_testbed`), attention's
gradient and the kernel wrappers' gradient guard, and `batch_iterator`.

Parameters are the reference's init carried across by `params_from_jax`;
inputs are made with numpy. Smoke configs in float32: ElasticBERT (2
layers, d 128, classification) and rwkv6-3b (2 layers, d 128, LM).
Tolerances, each float32 sums taken in another order:
  LOSS_RTOL      loss of one forward (the train_loss test);
  GRAD_RTOL      a gradient leaf, as max |err| over max |reference|;
  STEP_RTOL      losses of consecutive train steps;
  PARAM_ATOL     parameters after the steps, on the elements whose
                 step-0 |grad| exceeds GRAD_FLOOR (below it a gradient's
                 sign may flip under rounding, and AdamW then moves the
                 element by ±lr);
  CONF_ATOL      exit confidences.
"""
import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import batch_iterator as j_batch_iterator
from repro.data import make_dataset
from repro.data.synthetic import VOCAB
from repro.kernels.flash_attention.ref import gqa_ref as j_gqa_ref
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.models.api import build_model as j_build_model
from repro.models.common import cross_entropy as j_cross_entropy
from repro.optim import adamw_init as j_adamw_init
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import batch_iterator
from repro_torch.kernels._build import grad_wanted
from repro_torch.kernels.exit_confidence.kernel import (
    exit_confidence_cuda, exit_confidence_fused_cuda)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     attention_backward)
from repro_torch.kernels.flash_attention.ref import gqa_ref
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.models.api import Model, build_model
from repro_torch.models.common import cross_entropy
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig, flatten

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_FLOOR = 1e-6
CONF_ATOL = 1e-5
ATTN_GRAD_RTOL = 1e-5      # attention_backward: a handful of f32 products

FAMILIES = {
    # dense classification: the ElasticBERT smoke config on the synthetic
    # vocabulary; ssm LM: the rwkv6-3b smoke config
    "dense-cls": ("elasticbert12", {"vocab_size": VOCAB, "num_classes": 2}),
    "ssm-lm": ("rwkv6-3b", {}),
}


def _cfgs(family):
    arch, over = FAMILIES[family]
    return tuple(dataclasses.replace(get(arch), dtype="float32", **over)
                 for get in (get_smoke_config, t_get_smoke_config))


def _batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    shape = (b,) if cfg.num_classes else (b, s)
    labels = rng.integers(0, cfg.num_classes or cfg.vocab_size,
                          shape).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _bridged(cfg, seed=0):
    jp = jtf.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _grads(params):
    return {n: np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy() for n, p in params.named_parameters()}


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("with_valid", [False, True])
def test_cross_entropy_matches_reference(with_valid):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    valid = (rng.random((3, 5)) < 0.6).astype(np.float32) if with_valid \
        else None
    ref = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          None if valid is None else jnp.asarray(valid))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_cross_entropy_of_no_valid_position_is_zero():
    logits = torch.randn((2, 3, 4))
    got = cross_entropy(logits, torch.zeros((2, 3), dtype=torch.int64),
                        torch.zeros((2, 3)))
    assert float(got) == 0.0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_loss_value_and_grads_match_reference(family):
    cfg, tcfg = _cfgs(family)
    jp, tp = _bridged(cfg)
    batch = _batch(cfg, 1)
    ref, jgrads = jax.value_and_grad(lambda p: jtf.train_loss(
        p, cfg, _jax(batch), remat=False))(jp)
    tp.requires_grad_(True)
    loss = ttf.train_loss(tp, tcfg, _torch(batch), remat=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=LOSS_RTOL)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = _grads(tp)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert _rel(g, want[name]) <= GRAD_RTOL, name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_equals_no_remat(family):
    """Recomputing each layer in the backward changes nothing: the same
    operations run again on the CPU, so loss and gradients are equal."""
    _, tcfg = _cfgs(family)
    params = ttf.init_params(tcfg, seed=2, device="cpu").requires_grad_(True)
    batch = _torch(_batch(tcfg, 3))
    out = {}
    for remat in (False, True):
        params.zero_grad(set_to_none=True)
        loss = ttf.train_loss(params, tcfg, batch, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), _grads(params))
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][name], g, err_msg=name)


def test_param_tree_trainability_is_explicit():
    _, tcfg = _cfgs("dense-cls")
    params = ttf.init_params(tcfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    assert params.requires_grad_(True) is params
    assert all(p.requires_grad for p in params.parameters())
    params.requires_grad_(False)
    assert not any(p.requires_grad for p in params.parameters())


# ---------------------------------------------------------- train steps

def _held_params(tp, want, grad0):
    """max |err| of the parameters over the elements whose step-0 |grad|
    exceeds GRAD_FLOOR."""
    worst = 0.0
    for name, p in tp.named_parameters():
        big = np.abs(grad0[name]) > GRAD_FLOOR
        if big.any():
            diff = np.abs(p.detach().numpy() - np.asarray(want[name]))
            worst = max(worst, float(diff[big].max()))
    return worst


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_steps_match_reference(family):
    """Five `make_train_step` steps from the same parameters on the same
    batches, under the cosine schedule with a short warmup."""
    cfg, tcfg = _cfgs(family)
    jp, tp = _bridged(cfg)
    tp.requires_grad_(True)
    kw = dict(total_steps=8, warmup=2, remat=False)
    jstep = jax.jit(jtrain.make_train_step(j_build_model(cfg),
                                           JAdamWConfig(), **kw))
    tstep = ttrain.make_train_step(build_model(tcfg), AdamWConfig(),
                                   **kw)
    jstate, tstate = j_adamw_init(jp), adamw_init(tp)
    grad0 = None
    for i in range(5):
        batch = _batch(cfg, 10 + i)
        jp, jstate, jinfo = jstep(jp, jstate, _jax(batch))
        tp, tstate, tinfo = tstep(tp, tstate, _torch(batch))
        np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(float(tinfo["gnorm"]),
                                   float(jinfo["gnorm"]), rtol=GRAD_RTOL)
        if grad0 is None:
            grad0 = _grads(tp)
    assert tstate["count"] == int(jstate["count"]) == 5
    want = flatten(jax.tree.map(np.asarray, jp))
    assert _held_params(tp, want, grad0) <= PARAM_ATOL


def test_train_classifier_matches_reference(monkeypatch):
    """The port's loop against the reference's from the same initial
    parameters (the port's init replaced by the bridged reference init):
    the same batches, logged steps and losses, and parameters."""
    cfg, tcfg = _cfgs("dense-cls")
    data = make_dataset("sst2_like", 256, seed=0)
    jp0, tp0 = _bridged(cfg, seed=0)
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None: tp0)
    kw = dict(steps=6, batch_size=16, seed=0, log_every=2)
    jparams, _, jlog = jtrain.train_classifier(cfg, data, **kw)
    tparams, tmodel, tlog = ttrain.train_classifier(tcfg, data, device="cpu",
                                                    **kw)
    assert isinstance(tmodel, Model)
    assert [r["step"] for r in tlog] == [r["step"] for r in jlog] == \
        [0, 2, 4, 5]
    np.testing.assert_allclose([r["loss"] for r in tlog],
                               [r["loss"] for r in jlog], rtol=STEP_RTOL)
    assert not any(p.requires_grad or p.grad is not None
                   for p in tparams.parameters())
    first = next(j_batch_iterator(data, 16, seed=0, epochs=1))
    grad0 = flatten(jax.tree.map(np.asarray, jax.grad(
        lambda p: jtf.train_loss(p, cfg, _jax(first), remat=False))(jp0)))
    want = flatten(jax.tree.map(np.asarray, jparams))
    assert _held_params(tparams, want, grad0) <= PARAM_ATOL


def test_exit_accuracy_matches_reference():
    cfg, tcfg = _cfgs("dense-cls")
    jp, tp = _bridged(cfg, seed=4)
    data = make_dataset("imdb_like", 40, seed=1)
    ref = jtrain.exit_accuracy(j_build_model(cfg), jp, data, batch_size=16)
    got = ttrain.exit_accuracy(build_model(tcfg), tp, data, batch_size=16)
    assert got[0].shape == (40, tcfg.num_layers) and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=0,
                               atol=CONF_ATOL)
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))


def test_build_testbed_matches_reference(monkeypatch):
    """The testbed from the same initial parameters: calibration
    confidences at CONF_ATOL, correctness equal away from a tie."""
    kw = dict(layers=2, steps=3, n_train=128, n_eval=64, seed=0)
    ref = jserve.build_testbed(**kw)
    jp0 = jtf.init_params(ref[0], jax.random.PRNGKey(0))
    tp0 = params_from_jax(jax.tree.map(np.asarray, jp0), device="cpu")
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None: tp0)
    got = tserve.build_testbed(device="cpu", **kw)
    cfg = got[0]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size, cfg.num_classes, cfg.dtype) == \
        (2, 128, 4, 512, VOCAB, 2, "float32")
    for a, b in zip(got[3:5], ref[3:5]):              # train and eval data
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    (conf, correct), (jconf, jcorrect) = got[5], ref[5]
    assert conf.shape == (1024, 2)
    np.testing.assert_allclose(conf, np.asarray(jconf), rtol=0,
                               atol=CONF_ATOL)
    away = np.abs(np.asarray(jconf) - 0.5) > 1e-3
    np.testing.assert_array_equal(correct[away], np.asarray(jcorrect)[away])
    assert [r["step"] for r in got[6]] == [r["step"] for r in ref[6]]


def test_model_facade():
    _, tcfg = _cfgs("dense-cls")
    model = build_model(tcfg)
    params = model.init(seed=1, device="cpu")
    toks = torch.from_numpy(_batch(tcfg, 0)["tokens"])
    with torch.no_grad():
        a = model.forward_exits(params, {"tokens": toks})
        b = ttf.forward_exits(params, tcfg, {"tokens": toks})
        m = model.forward_exits_masked(params, {"tokens": toks},
                                       torch.full((4,), tcfg.num_layers - 1))
    assert torch.equal(a["conf"], b["conf"])
    assert torch.equal(m["pred"], a["pred"])
    # decode runs (tests/test_torch_decode.py holds it to the reference)
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks},
                                       cache_seq_len=toks.shape[1] + 1)
        assert model.init_caches(4, toks.shape[1] + 1, device="cpu")[
            "attn"]["k"].shape == caches["attn"]["k"].shape
        tok = logits.argmax(-1)
        depths = torch.full((4,), tcfg.num_layers - 1)
        step = model.decode_step(params, caches, tok, toks.shape[1],
                                 all_exits=True)
        edge = model.decode_step_masked(params, caches, tok, toks.shape[1],
                                        depths)
        cloud = model.decode_step_resume(params, caches, edge[3],
                                         toks.shape[1], depths,
                                         torch.ones(4, dtype=torch.bool))
    assert torch.equal(step[0], edge[0])
    assert cloud[0].shape == step[0].shape
    # an audio config without an encoder is a decoder-only stack, as the
    # reference's facade takes it: the same prefill on the bridged weights
    cfg = dataclasses.replace(_cfgs("dense-cls")[0], family="audio")
    audio = build_model(dataclasses.replace(tcfg, family="audio"))
    assert not audio.is_encdec
    jaudio = j_build_model(cfg)
    jp = jaudio.init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want = jaudio.prefill(jp, {"tokens": jnp.asarray(toks.numpy())})[0]
    with torch.no_grad():
        got = audio.prefill(tp, {"tokens": toks})[0]
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               rtol=1e-5, atol=1e-5)


def test_train_main_on_cpu(capsys):
    ttrain.main(["--device", "cpu", "--smoke", "--steps", "3",
                 "--n-train", "256"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


def test_train_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this process has CUDA; the guard is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--steps", "1", "--n-train", "128"])


# ----------------------------------------------------- batch_iterator

@pytest.mark.parametrize("seed,batch,drop,epochs", [
    (0, 16, True, 1), (3, 7, True, 2), (5, 10, False, 3)])
def test_batch_iterator_bitwise_equal_reference(seed, batch, drop, epochs):
    data = make_dataset("rte_like", 53, seed=seed)
    got = list(batch_iterator(data, batch, seed=seed, drop_remainder=drop,
                              epochs=epochs))
    ref = list(j_batch_iterator(data, batch, seed=seed, drop_remainder=drop,
                                epochs=epochs))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------- attention's gradient

ATTN_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window
    (2, 4, 4, 32, 32, 16, False, 0),     # bidirectional (ElasticBERT)
    (1, 4, 4, 40, 40, 32, True, 0),      # causal
    (2, 4, 2, 24, 24, 16, True, 0),      # GQA, causal
    (1, 2, 2, 48, 48, 16, True, 8),      # sliding window
    (1, 4, 2, 7, 30, 16, True, 0),       # GQA, suffix queries
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", ATTN_CASES)
def test_attention_backward_matches_autograd(b, hq, hkv, sq, skv, d, causal,
                                             window):
    """`attention_backward` against `jax.vjp` of the reference's plain
    attention and against torch autograd of the port's."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    dout = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    _, vjp = jax.vjp(lambda *x: j_gqa_ref(*x, **kw), *map(jnp.asarray,
                                                          (q, k, v)))
    want_jax = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = gqa_ref(*leaves, **kw)
    want_torch = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    got = attention_backward(*map(torch.from_numpy, (q, k, v)), out.detach(),
                             torch.from_numpy(dout), scale=d ** -0.5, **kw)
    for g, wj, wt in zip(got, want_jax, want_torch):
        assert g.shape == wt.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), np.asarray(wj)) <= ATTN_GRAD_RTOL
        assert _rel(g.numpy(), wt.numpy()) <= ATTN_GRAD_RTOL


def test_attention_backward_gives_no_gradient_to_rows_without_keys():
    """Causal queries placed before the first key attend nothing (the
    kernel's output there is exactly 0), so they get no gradient."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(
        rng.standard_normal((1, 2, 10, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 4, 16))
                             .astype(np.float32)) for _ in range(2))
    out = gqa_ref(q, k, v, causal=True)
    out[:, :, :6] = 0.0
    dq, dk, dv = attention_backward(q, k, v, out, torch.ones_like(out),
                                    causal=True, window=0, scale=0.25)
    assert (dq[:, :, :6] == 0).all() and dq[:, :, 6:].abs().sum() > 0
    _, dk_tail, dv_tail = attention_backward(
        q[:, :, 6:], k, v, out[:, :, 6:], torch.ones_like(out[:, :, 6:]),
        causal=True, window=0, scale=0.25)
    torch.testing.assert_close(dk, dk_tail, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv, dv_tail, rtol=1e-6, atol=1e-6)


def test_flash_attention_function_backward_is_attention_backward():
    rng = np.random.default_rng(2)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 4, 8, 16))
                                      .astype(np.float32)) for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    out = gqa_ref(q, k, v, causal=True)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, out), causal=True,
                                window=0)
    got = FlashAttention.backward(ctx, dout)
    want = attention_backward(q, k, v, out, dout, causal=True, window=0,
                              scale=16 ** -0.5)
    assert got[3:] == (None, None)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)


# --------------------------------------------- the wrappers' grad guard

@pytest.mark.parametrize("grad_mode,requires", list(itertools.product(
    (True, False), ((), (0,), (1,), (0, 1)))))
def test_grad_wanted_is_grad_mode_and_an_input_requiring_grad(grad_mode,
                                                              requires):
    ts = [torch.zeros(2, requires_grad=i in requires) for i in range(2)]
    with torch.set_grad_enabled(grad_mode):
        assert grad_wanted(*ts, None) == (grad_mode and bool(requires))


def _wrapper_calls():
    x = torch.randn((4, 8))
    w = torch.randn((8, 3))
    q = torch.randn((1, 2, 4, 8))
    u = torch.randn((2, 8))
    return {
        "flash_attention_cuda": (lambda t: flash_attention_cuda(t, q, q),
                                 q, "needs CUDA"),
        "wkv6_cuda": (lambda t: wkv6_cuda(t, q, q, q, u), q, "CUDA device"),
        "exit_confidence_cuda": (lambda t: exit_confidence_cuda(t, w), x,
                                 "CUDA"),
        "exit_confidence_fused_cuda": (
            lambda t: exit_confidence_fused_cuda(t, torch.ones(8), None, w,
                                                 None, kind="rmsnorm"),
            x, "CUDA"),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_cuda_wrappers_refuse_a_gradient(name):
    """A wrapper whose kernel fills its outputs through ctypes would hand
    back a tensor cut from the autograd graph: under grad it raises
    before anything else (here, before its device check); without grad
    it goes on to that check."""
    call, x, device_msg = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call(x.clone().requires_grad_(True))
    with torch.no_grad(), pytest.raises(ValueError, match=device_msg):
        call(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match=device_msg):
        call(x)
