"""Port vs reference: decode serving (serving/kvcache.py,
serving/decode.py, and ``workload="decode"`` through `serve()`,
`Engine` and `MultiTenantEngine`).

* the closed-form wire accounting (`per_step_layer_bytes`,
  `step_slice_bytes`, `hidden_raw_bytes`, `offload_scale_vec`) equals the
  reference's for both archs, in float32 and bfloat16, with and without
  a codec; `DecodeCacheManager` keeps the reference's ledgers and its
  per-sequence error-feedback residuals (bitwise, on the rows' device);
* `serve(workload="decode")` in bandit, forced-final and int8 +
  error-feedback runs, at an α between the exit confidences and at one
  above all of them: tokens, arms, exits, preds, offload bytes and every
  key and array of the ``decode`` section equal the reference's
  `serve()` on the same bridged params and prompts (the reference's
  prefill attention and exit heads in Pallas interpret mode); rewards
  and cost within 1e-6;
* an `Engine` fed in ragged chunks equals the one-shot run; a
  `MultiTenantEngine` with a decode tenant (qwen3) and a classify tenant
  (ElasticBERT) equals the two solo engines;
* the decode `ServingConfig` messages, the runtime/session type guards
  and the ragged-prompt error are the reference's;
* the port's own pins: forced-final serving equals a plain `decode_step`
  loop bitwise (tokens, per-step logits, final cache); a bandit run's
  ledger replayed from a fresh prefill regenerates its tokens; an
  offload at quant "none" re-syncs to the full-depth step bitwise.

float32 smoke configs (qwen3-1.7b dense GQA, rwkv6-3b ssm) cut to 3
layers; prompts of 4 tokens from a numpy seed, 3 generated tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.models import transformer as jtf
from repro.serving import DecodeRuntime as JDecodeRuntime
from repro.serving import ServingConfig as JConfig
from repro.serving import serve as jserve
from repro.serving.decode import _DecodeSession as JSession
from repro.serving.kvcache import DecodeCacheManager as JManager
from repro.serving import kvcache as jkv
from repro.serving.offload_codec import OffloadCodec as JCodec
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.models import transformer as ttf
from repro_torch.serving import (DecodeRuntime, EdgeCloudRuntime, Engine,
                                 MultiTenantEngine, ServingConfig,
                                 TenantSpec, serve)
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.decode import _DecodeSession
from repro_torch.serving.offload_codec import OffloadCodec

ARCHS = ["qwen3-1.7b", "rwkv6-3b"]
LAYERS = 3
S, T = 4, 3                  # prompt length, generated tokens
FLOAT_ATOL = 1e-6
_BEDS = {}


def _cfgs(arch, dtype="float32"):
    kw = dict(num_layers=LAYERS, dtype=dtype)
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(t_get_smoke_config(arch), **kw))


def _prompts(vocab, n, seed, length=S):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, size=length)}
            for _ in range(n)]


def _bed(arch):
    """Bridged params, both runtimes, and α in the widest gap of the
    middle half of the first step's intermediate exit confidences."""
    if arch not in _BEDS:
        cfg, tcfg = _cfgs(arch)
        jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        trt = DecodeRuntime(tcfg, device="cpu")
        prompts = np.stack([s["tokens"] for s in
                            _prompts(cfg.vocab_size, 16, 99)]).astype(np.int32)
        lg, caches = trt.prefill_fn(tp, prompts, S + 1)
        conf = trt.edge_fn(tp, caches, lg.argmax(-1), S,
                           torch.full((16,), LAYERS - 1), S + 1)[1]
        conf = np.sort(conf[:-1].numpy().ravel())
        lo, hi = len(conf) // 4, 3 * len(conf) // 4
        k = lo + int(np.argmax(np.diff(conf[lo:hi])))
        alpha = float(conf[k] + conf[k + 1]) / 2
        _BEDS[arch] = dict(
            cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, trt=trt, alpha=alpha,
            jrt=JDecodeRuntime(cfg, backend="pallas_interpret",
                               conf_backend="pallas_interpret"))
    return _BEDS[arch]


def _costs(alpha):
    return (JCostModel(num_layers=LAYERS, alpha=alpha, offload=3.0),
            CostModel(num_layers=LAYERS, alpha=alpha, offload=3.0))


def _trees_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_trees_equal(a[k], b[k])
                                              for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


DECODE_KEYS = ("tokens", "realized_depths", "exited_steps",
               "offloaded_steps", "offloads_per_sequence",
               "wire_bytes_per_sequence", "exits_per_layer_per_step")


def _assert_decode_reports_match(got, ref):
    """Decisions and byte counts exactly, floats within FLOAT_ATOL, the
    same report keys and decode keys (wall-clock values aside)."""
    assert got.path == ref.path == "decode"
    assert sorted(got.keys()) == sorted(ref.keys())
    assert got.n == ref.n and got.offload_bytes == ref.offload_bytes
    for key in ("preds", "arms", "exited"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got.rewards),
                               np.asarray(ref.rewards), rtol=0,
                               atol=FLOAT_ATOL)
    assert abs(got.cost_total - ref.cost_total) <= FLOAT_ATOL * max(1, got.n)
    assert abs(got.offload_frac - ref.offload_frac) <= FLOAT_ATOL
    assert sorted(got.decode) == sorted(ref.decode)
    for key in DECODE_KEYS:
        np.testing.assert_array_equal(np.asarray(got.decode[key]),
                                      np.asarray(ref.decode[key]),
                                      err_msg=key)
    for key in ("max_new_tokens", "split_policy", "sequences",
                "tokens_generated"):
        assert got.decode[key] == ref.decode[key], key


# ------------------------------------------------------ kvcache closed forms

CODECS = [None, dict(quant="int8"), dict(quant="int4", sparsity=0.5),
          dict(quant="none", sparsity=0.25)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_wire_accounting_equals_reference(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    want = jkv.per_step_layer_bytes(cfg)
    got = tkv.per_step_layer_bytes(tcfg)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.sum() > 0
    for depth in range(LAYERS):
        assert tkv.step_slice_bytes(tcfg, depth) == \
            jkv.step_slice_bytes(cfg, depth)
    assert tkv.hidden_raw_bytes(tcfg) == jkv.hidden_raw_bytes(cfg)
    for kw in CODECS:
        jc = None if kw is None else JCodec(**kw)
        tc = None if kw is None else OffloadCodec(**kw)
        np.testing.assert_array_equal(tkv.offload_scale_vec(tcfg, tc),
                                      jkv.offload_scale_vec(cfg, jc))


def test_cache_manager_ledgers_and_residuals():
    """The manager's ledgers, wire bytes and per-sequence error-feedback
    residuals (kept on the rows' device) equal the reference manager's
    over two offload rounds; an untouched row's residual stays 0."""
    b = _bed("qwen3-1.7b")
    cfg, tcfg = b["cfg"], b["tcfg"]
    prompts = np.stack([s["tokens"] for s in
                        _prompts(cfg.vocab_size, 3, 17)]).astype(np.int32)
    _, jcaches = b["jrt"].prefill_fn(b["jp"], jnp.asarray(prompts), S + 1)
    _, tcaches = b["trt"].prefill_fn(b["tp"], prompts, S + 1)
    jm = JManager(cfg, jcaches, codec=JCodec(quant="int8",
                                             error_feedback=True))
    tm = tkv.DecodeCacheManager(tcfg, tcaches, codec=OffloadCodec(
        quant="int8", error_feedback=True))
    assert tm.batch == jm.batch == 3
    assert tm._residual.device.type == "cpu"
    rng = np.random.default_rng(0)
    depths = np.asarray([0, 2, 1])
    for rows in (np.asarray([0, 2]), np.asarray([2])):
        hidden = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jdec, jwire = jm.ship_hidden(hidden, rows)
        tdec, twire = tm.ship_hidden(torch.from_numpy(hidden),
                                     torch.from_numpy(rows))
        assert twire == jwire
        np.testing.assert_array_equal(tdec.numpy(), jdec)
        np.testing.assert_array_equal(tm._residual.numpy(), jm._residual)
        np.testing.assert_array_equal(tm.meter(rows, depths, twire),
                                      jm.meter(rows, depths, jwire))
    np.testing.assert_array_equal(tm._residual[1].numpy(), 0.0)
    np.testing.assert_array_equal(tm.offloads_per_seq, jm.offloads_per_seq)
    np.testing.assert_array_equal(tm.wire_bytes_per_seq,
                                  jm.wire_bytes_per_seq)
    for m in (tm, jm):
        m.commit_edge(m.caches, depths)
        m.note_no_offload()
        m.commit_cloud(m.caches, np.asarray([True, False, True]))
    np.testing.assert_array_equal(np.stack(tm.realized_depths),
                                  np.stack(jm.realized_depths))
    np.testing.assert_array_equal(np.stack(tm.offloaded),
                                  np.stack(jm.offloaded))
    # without a codec the hidden ships as is, at its raw bytes
    plain = tkv.DecodeCacheManager(tcfg, tcaches)
    h = torch.randn(3, 1, cfg.d_model)
    dec, wire = plain.ship_hidden(h, torch.tensor([1]))
    assert torch.equal(dec, h[[1]]) and wire == tkv.hidden_raw_bytes(tcfg)


# ------------------------------------------------------------ serve() runs

RUNS = {
    "bandit": dict(),
    "final": dict(split_policy="final"),
    "int8_feedback": dict(offload_quant="int8", offload_error_feedback=True),
}


@pytest.mark.parametrize("alpha_kind", ["calibrated", "0.5"])
@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_matches_reference(arch, run, alpha_kind):
    """At the calibrated α tokens exit and offload at intermediate arms;
    at 0.5 (above every confidence of the smoke models) only the final
    arm exits."""
    b = _bed(arch)
    alpha = b["alpha"] if alpha_kind == "calibrated" else 0.5
    jcost, tcost = _costs(alpha)
    samples = _prompts(b["cfg"].vocab_size, 10, seed=5)
    kw = dict(batch_size=4, workload="decode", max_new_tokens=T, **RUNS[run])
    ref = jserve(b["jrt"], b["jp"], iter(samples), jcost, JConfig(**kw))
    got = serve(b["trt"], b["tp"], iter(samples), tcost, ServingConfig(**kw))
    _assert_decode_reports_match(got, ref)
    dec = got.decode
    assert dec["tokens"].shape == (10, T) and got.n == 10 * T
    assert dec["tokens_per_sec"] > 0 and dec["decode_wall_s"] > 0
    np.testing.assert_array_equal(dec["exited_steps"] ^
                                  dec["offloaded_steps"], True)
    if run == "final":
        np.testing.assert_array_equal(dec["realized_depths"], LAYERS - 1)
        assert got.offload_bytes == 0
    elif alpha_kind == "calibrated":
        ex = dec["exited_steps"] & (dec["realized_depths"] < LAYERS - 1)
        assert ex.any() and dec["offloaded_steps"].any()


def test_engine_decode_matches_one_shot_serve():
    """An `Engine` fed in ragged chunks (plain and with the fifo
    scheduler) equals the one-shot `serve()`."""
    b = _bed("rwkv6-3b")
    _, tcost = _costs(b["alpha"])
    samples = _prompts(b["cfg"].vocab_size, 12, seed=11)
    config = ServingConfig(batch_size=4, workload="decode",
                           max_new_tokens=T)
    ref = serve(b["trt"], b["tp"], iter(samples), tcost, config)
    for sched in ("none", "fifo"):
        eng = Engine(b["trt"], b["tp"], tcost,
                     dataclasses.replace(config, scheduler=sched))
        i = 0
        for chunk in (3, 1, 5, 2, 1):
            eng.submit(samples[i:i + chunk])
            i += chunk
        got = eng.close()
        assert got.path == "decode"
        for key in ("preds", "arms", "rewards", "exited"):
            np.testing.assert_array_equal(got[key], ref[key])
        assert got.cost_total == ref.cost_total
        for key in DECODE_KEYS:
            np.testing.assert_array_equal(got.decode[key], ref.decode[key])
        assert (got.scheduler is not None) == (sched == "fifo")


def test_multi_tenant_decode_and_classify_match_solo_engines():
    """A decode tenant (qwen3) and a classify tenant (ElasticBERT) behind
    one `MultiTenantEngine`, submits interleaved: each tenant's report
    equals its solo `Engine`'s, and the decode tenant's tokens equal the
    reference's `serve()`."""
    a = _bed("qwen3-1.7b")
    jcost_a, cost_a = _costs(a["alpha"])
    sc_a = ServingConfig(batch_size=2, workload="decode", max_new_tokens=2)
    _, cfg_b = _cfgs("elasticbert12")
    cfg_b = dataclasses.replace(cfg_b, num_layers=2)
    p_b = ttf.init_params(cfg_b, seed=0, device="cpu")
    rt_b = EdgeCloudRuntime(cfg_b, device="cpu")
    cost_b = CostModel(num_layers=2, alpha=0.5)
    sc_b = ServingConfig(batch_size=2)
    rng = np.random.default_rng(21)
    sa = _prompts(a["cfg"].vocab_size, 5, seed=21)
    sb = [{"tokens": rng.integers(0, cfg_b.vocab_size, size=8),
           "label": int(rng.integers(0, 2))} for _ in range(5)]
    mte = MultiTenantEngine({
        "alpha": TenantSpec(a["trt"], a["tp"], cost_a, sc_a),
        "beta": TenantSpec(rt_b, p_b, cost_b, sc_b)})
    for x, y in zip(sa, sb):
        mte.submit("alpha", [x])
        mte.submit("beta", [y])
    reps = mte.close()
    for name, rt, p, cost, sc, samples in (
            ("alpha", a["trt"], a["tp"], cost_a, sc_a, sa),
            ("beta", rt_b, p_b, cost_b, sc_b, sb)):
        eng = Engine(rt, p, cost, sc)
        for s in samples:
            eng.submit(s)
        solo = eng.close()
        r = reps[name]
        assert r.tenant == name and r.n == solo.n
        for key in ("preds", "arms", "rewards", "exited"):
            np.testing.assert_array_equal(r[key], solo[key])
        assert r.cost_total == solo.cost_total
        assert r.offload_bytes == solo.offload_bytes
        led = r.scheduler["tenant"]
        assert led["submitted"] == 5 == led["served"]
        assert led["shed"] == 0 and led["pending"] == 0
    assert reps["beta"].decode is None
    ref = jserve(a["jrt"], a["jp"], iter(sa), jcost_a,
                 JConfig(batch_size=2, workload="decode", max_new_tokens=2))
    np.testing.assert_array_equal(reps["alpha"].decode["tokens"],
                                  ref.decode["tokens"])


# ---------------------------------------------------- validation and guards

DECODE_INVALID = [
    dict(workload="streaming"), dict(workload="decode"),
    dict(workload="decode", max_new_tokens=1, split_policy="greedy"),
    dict(max_new_tokens=4), dict(split_policy="final"),
    dict(workload="decode", max_new_tokens=1, distributed=True),
    dict(workload="decode", max_new_tokens=1, fault_tolerant=True),
    dict(workload="decode", max_new_tokens=1, record_trace=True),
    dict(workload="decode", max_new_tokens=1, side_info=True),
    dict(workload="decode", max_new_tokens=1, replicas=2),
    dict(workload="decode", max_new_tokens=1, edge_mode="scan"),
    dict(workload="decode", max_new_tokens=1, offload_error_feedback=True),
]


@pytest.mark.parametrize("kwargs", DECODE_INVALID)
def test_decode_config_messages_equal_reference(kwargs):
    with pytest.raises(ValueError) as ref:
        JConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        ServingConfig(**kwargs)
    assert str(got.value) == str(ref.value)


def test_decode_config_resolves_and_round_trips():
    ok = ServingConfig(workload="decode", max_new_tokens=4)
    assert ok.resolved_path() == "decode" == \
        JConfig(workload="decode", max_new_tokens=4).resolved_path()
    assert ok.split_policy == "bandit"
    assert ServingConfig.from_json(ok.to_json()) == ok
    assert JConfig.from_json(ok.to_json()).workload == "decode"


def _raised(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def test_runtime_and_session_type_guards():
    """The reference's errors, message for message: a DecodeRuntime under
    a classify config (serve and Engine), a classifier runtime under a
    decode config; the runtime's own guards."""
    b = _bed("qwen3-1.7b")
    jcost, tcost = _costs(0.5)
    classify = dict(batch_size=2)
    assert _raised(lambda: serve(b["trt"], b["tp"], iter([]), tcost,
                                 ServingConfig(**classify)), ValueError) == \
        _raised(lambda: jserve(b["jrt"], b["jp"], iter([]), jcost,
                               JConfig(**classify)), ValueError)
    with pytest.raises(ValueError, match="DecodeRuntime"):
        Engine(b["trt"], b["tp"], tcost, ServingConfig(**classify))
    _, cfg_c = _cfgs("elasticbert12")
    from repro.serving import EdgeCloudRuntime as JEdgeCloudRuntime
    jmsg = _raised(lambda: JSession(JEdgeCloudRuntime(_cfgs(
        "elasticbert12")[0]), None, jcost), TypeError)
    assert _raised(lambda: _DecodeSession(
        EdgeCloudRuntime(cfg_c, device="cpu"), None, tcost),
        TypeError) == jmsg
    assert _raised(lambda: _DecodeSession(b["trt"], b["tp"], tcost,
                                          max_new_tokens=0), ValueError) == \
        _raised(lambda: JSession(b["jrt"], b["jp"], jcost,
                                 max_new_tokens=0), ValueError)
    cfg = b["tcfg"]
    for bad, jbad in (
            (dict(modality="vision_stub"), dict(modality="vision_stub")),):
        assert _raised(lambda: DecodeRuntime(
            dataclasses.replace(cfg, **bad), device="cpu"),
            NotImplementedError) == _raised(lambda: JDecodeRuntime(
                dataclasses.replace(b["cfg"], **jbad)), NotImplementedError)
    # a VLM config with text modality is served, as the reference serves
    # it: the same prefill over token prompts
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jl, _ = JDecodeRuntime(dataclasses.replace(b["cfg"], family="vlm")
                           ).prefill_fn(b["jp"], jnp.asarray(prompts), 6)
    tl, _ = DecodeRuntime(dataclasses.replace(cfg, family="vlm"),
                          device="cpu").prefill_fn(b["tp"], prompts, 6)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="params on"):
        DecodeRuntime(cfg, device="cpu").prefill_fn(
            {"embed": torch.zeros(1, device="meta")}, np.zeros((1, 2)), 3)


def test_ragged_prompts_raise_the_reference_error():
    b = _bed("qwen3-1.7b")
    jcost, tcost = _costs(0.5)
    batch = [{"tokens": np.arange(4)}, {"tokens": np.arange(5)}]
    sess = _DecodeSession(b["trt"], b["tp"], tcost)
    jsess = JSession(b["jrt"], b["jp"], jcost)
    assert _raised(lambda: sess.push(batch), ValueError) == \
        _raised(lambda: jsess.push(batch), ValueError)
    sess.push([])                         # an empty push is a no-op
    assert sess.result()["n"] == 0
    assert sess.result()["decode"]["tokens"].shape == (0, 1)


# ------------------------------------------------------- the port's own pins

@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_forced_final_equals_plain_decode_loop_bitwise(arch, B):
    """serve(split_policy="final") == a plain full-depth `decode_step`
    loop: tokens, per-step logits (replaying the session's edge calls)
    and the final cache tree, bitwise."""
    b = _bed(arch)
    rt, params, cfg = b["trt"], b["tp"], b["tcfg"]
    _, tcost = _costs(b["alpha"])
    samples = _prompts(cfg.vocab_size, B, seed=3)
    rep = serve(rt, params, iter(samples), tcost,
                ServingConfig(batch_size=B, workload="decode",
                              max_new_tokens=T, split_policy="final"))
    total = S + T
    prompts = np.stack([s["tokens"] for s in samples]).astype(np.int32)
    logits0, caches = rt.prefill_fn(params, prompts, total)
    tok = logits0.argmax(-1)
    ref_tokens, ref_logits = [], []
    with torch.no_grad():
        for t in range(T):
            lg, _, _, caches = ttf.decode_step(params, cfg, caches, tok,
                                               S + t, all_exits=True,
                                               window_seq_len=total)
            tok = lg.argmax(-1)
            ref_tokens.append(tok.numpy())
            ref_logits.append(lg)
    np.testing.assert_array_equal(rep.decode["tokens"],
                                  np.stack(ref_tokens, 1))
    logits0, m_caches = rt.prefill_fn(params, prompts, total)
    tok = logits0.argmax(-1)
    depths = torch.full((B,), LAYERS - 1)
    for t in range(T):
        lg, _, _, _, pred_fin, _, m_caches = rt.edge_fn(
            params, m_caches, tok, S + t, depths, total)
        assert torch.equal(lg, ref_logits[t])
        tok = pred_fin
    assert _trees_equal(caches, m_caches)
    assert rep.decode["offloads_per_sequence"].sum() == 0


def _replay(rt, params, prompts, dec):
    """Regenerate a report's tokens from a FRESH prefill, driving the
    edge/cloud calls with its recorded depths and offloads only."""
    L = rt.cfg.num_layers
    B, T_ = dec["tokens"].shape
    Sp = prompts.shape[1]
    total = Sp + T_
    logits0, caches = rt.prefill_fn(params, prompts, total)
    tok = logits0.argmax(-1)
    gen = np.zeros((B, T_), np.int32)
    for t in range(T_):
        arms = np.asarray(dec["realized_depths"][:, t])
        depths = torch.from_numpy(arms)
        _, _, pred, _, pred_fin, hidden, caches = rt.edge_fn(
            params, caches, tok, Sp + t, depths, total)
        toks = np.where(arms + 1 == L, pred_fin.numpy(),
                        pred.numpy()[arms, np.arange(B)])
        off = np.asarray(dec["offloaded_steps"][:, t], bool)
        if off.any():
            _, _, pred_l, caches = rt.cloud_fn(
                params, caches, hidden, Sp + t, depths,
                torch.from_numpy(off), total)
            toks[off] = pred_l.numpy()[off]
        gen[:, t] = toks
        tok = torch.from_numpy(toks.astype(np.int64))
    return gen


@pytest.mark.parametrize("arch", ARCHS)
def test_bandit_run_replays_from_fresh_cache(arch):
    """The KV-consistency pin: a bandit run's ledger (realized depths and
    offloads) regenerates its tokens from a fresh prefill."""
    b = _bed(arch)
    _, tcost = _costs(b["alpha"])
    samples = _prompts(b["tcfg"].vocab_size, 8, seed=5)
    rep = serve(b["trt"], b["tp"], iter(samples), tcost,
                ServingConfig(batch_size=8, workload="decode",
                              max_new_tokens=T))
    dec = rep.decode
    assert len(np.unique(dec["realized_depths"])) >= 2
    assert dec["offloaded_steps"].sum() > 0
    prompts = np.stack([s["tokens"] for s in samples]).astype(np.int32)
    np.testing.assert_array_equal(_replay(b["trt"], b["tp"], prompts, dec),
                                  dec["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_resync_at_quant_none_is_the_full_step(arch):
    """edge(ℓ) + a resume of every row == one full-depth step, bitwise in
    logits and the whole cache tree; an all-inactive resume is a no-op."""
    b = _bed(arch)
    rt, params = b["trt"], b["tp"]
    rng = np.random.default_rng(7)
    B = 6
    prompts = rng.integers(0, b["tcfg"].vocab_size, (B, S)).astype(np.int32)
    _, caches = rt.prefill_fn(params, prompts, S + 1)
    tok = torch.from_numpy(rng.integers(0, b["tcfg"].vocab_size, B))
    depths = torch.from_numpy(rng.integers(0, LAYERS, B))
    lg_full, _, _, _, _, _, c_full = rt.edge_fn(
        params, caches, tok, S, torch.full((B,), LAYERS - 1), S + 1)
    _, _, _, _, _, hidden, c_edge = rt.edge_fn(params, caches, tok, S,
                                               depths, S + 1)
    lg_res, _, _, c_res = rt.cloud_fn(params, c_edge, hidden, S, depths,
                                      torch.ones(B, dtype=torch.bool), S + 1)
    assert torch.equal(lg_full, lg_res)
    assert _trees_equal(c_full, c_res)
    _, _, _, c_noop = rt.cloud_fn(params, c_edge, hidden, S, depths,
                                  torch.zeros(B, dtype=torch.bool), S + 1)
    assert _trees_equal(c_edge, c_noop)
