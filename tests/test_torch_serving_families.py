"""Port vs reference: SplitEE serving of the hybrid (zamba2-1.2b) and MoE
(phi3.5-moe) families through the port's front door.

The reference's `init_params` for the float32 smoke configs (zamba2 at 4
layers, the shared block after layers 1 and 3; phi3.5-moe at 3 layers,
4 experts, top-2) is bridged into the port, and both packages serve the
same numpy-seeded streams:

* `serve()` on the bucketed (plain; fused exits with SplitEE-S), scan,
  auto, sequential and int8-offload paths, at an alpha in a gap of the
  stream's confidences: arms, exits, preds and offload bytes exactly
  equal, rewards and cost within 1e-6 (int8: 1e-3, the codec's grid can
  move by one quantum between the frameworks' last-bit differences). The
  bucketed path's pow2 padding rows route through the MoE layers and
  compete for capacity, as in the reference;
* `serve(workload="decode")` bandit and forced-final: tokens, decisions,
  offload bytes and the decode ledgers equal;
* the port's own pin: forced-final serving equals a plain `decode_step`
  loop bitwise (tokens, per-step logits, final cache tree).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.data import OnlineStream, make_dataset
from repro.models import transformer as jtf
from repro.serving import DecodeRuntime as JDecodeRuntime
from repro.serving.api import ServingConfig as JConfig
from repro.serving.api import serve as jserve
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.models import transformer as ttf
from repro_torch.serving import (DecodeRuntime, EdgeCloudRuntime,
                                 ServingConfig, serve)

LAYERS = {"zamba2-1.2b": 4, "phi3.5-moe-42b-a6.6b": 3}
ARCHS = sorted(LAYERS)
N_SAMPLES = 37            # a ragged tail at B = 8
ALPHA_MARGIN = 1e-4
FLOAT_ATOL = 1e-6
CODEC_FLOAT_ATOL = 1e-3
S, T = 4, 3               # decode: prompt length, generated tokens
_BEDS = {}


def _bed(arch):
    if arch not in _BEDS:
        kw = dict(num_layers=LAYERS[arch], dtype="float32")
        cfg = dataclasses.replace(get_smoke_config(arch), **kw)
        tcfg = dataclasses.replace(t_get_smoke_config(arch), **kw)
        jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        data = make_dataset("imdb_like", N_SAMPLES, seed=1)
        conf = np.sort(np.asarray(jtf.forward_exits(
            jp, cfg, {"tokens": jnp.asarray(data["tokens"])})["conf"]).ravel())
        lo, hi = len(conf) // 4, 3 * len(conf) // 4
        k = lo + int(np.argmax(np.diff(conf[lo:hi])))
        alpha = float(conf[k] + conf[k + 1]) / 2
        assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
        _BEDS[arch] = dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, alpha=alpha)
    return _BEDS[arch]


SERVE_RUNS = {
    "bucketed": (dict(batch_size=8), False, FLOAT_ATOL),
    "bucketed_fused_side_info": (dict(batch_size=8, side_info=True), True,
                                 FLOAT_ATOL),
    "scan": (dict(batch_size=8, edge_mode="scan"), False, FLOAT_ATOL),
    "auto_side_info": (dict(batch_size=8, edge_mode="auto", side_info=True),
                       False, FLOAT_ATOL),
    "sequential": (dict(max_samples=12), False, FLOAT_ATOL),
    "int8": (dict(batch_size=8, offload_quant="int8"), False,
             CODEC_FLOAT_ATOL),
}


@pytest.mark.parametrize("run", sorted(SERVE_RUNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch, run):
    b = _bed(arch)
    kw, fused, atol = SERVE_RUNS[run]
    ref = jserve(JRuntime(b["cfg"], backend="ref",
                          conf_backend="pallas_interpret", fused_exit=fused),
                 b["jp"],
                 OnlineStream(make_dataset("imdb_like", N_SAMPLES, seed=1),
                              seed=0),
                 JCostModel(num_layers=LAYERS[arch], alpha=b["alpha"],
                            offload=3.0), JConfig(**kw))
    got = serve(EdgeCloudRuntime(b["tcfg"], device="cpu", fused_exit=fused),
                b["tp"],
                TStream(t_make_dataset("imdb_like", N_SAMPLES, seed=1),
                        seed=0),
                CostModel(num_layers=LAYERS[arch], alpha=b["alpha"],
                          offload=3.0), ServingConfig(**kw))
    assert got.path == ref.path
    assert got.n == ref.n
    for key in ("arms", "exited", "preds", "exits_per_layer"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got.offload_bytes == ref.offload_bytes
    assert abs(got.cost_total - ref.cost_total) <= atol * got.n
    np.testing.assert_allclose(got.rewards, ref.rewards, rtol=0, atol=atol)
    assert 0 < ref.exited.sum() < ref.n


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, size=S)} for _ in range(n)]


def _decode_alpha(b):
    """An alpha in the widest gap of the middle half of the first edge
    step's intermediate exit confidences."""
    trt = DecodeRuntime(b["tcfg"], device="cpu")
    prompts = np.stack([s["tokens"] for s in _prompts(
        b["cfg"].vocab_size, 16, 99)]).astype(np.int32)
    lg, caches = trt.prefill_fn(b["tp"], prompts, S + 1)
    L = b["cfg"].num_layers
    conf = trt.edge_fn(b["tp"], caches, lg.argmax(-1), S,
                       torch.full((16,), L - 1), S + 1)[1]
    conf = np.sort(conf[:-1].numpy().ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    return float(conf[k] + conf[k + 1]) / 2


DECODE_KEYS = ("tokens", "realized_depths", "exited_steps",
               "offloaded_steps", "offloads_per_sequence",
               "wire_bytes_per_sequence", "exits_per_layer_per_step")


@pytest.mark.parametrize("policy", ["bandit", "final"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_matches_reference(arch, policy):
    b = _bed(arch)
    alpha = _decode_alpha(b)
    L = LAYERS[arch]
    samples = _prompts(b["cfg"].vocab_size, 8, seed=5)
    kw = dict(batch_size=4, workload="decode", max_new_tokens=T,
              split_policy=policy)
    ref = jserve(JDecodeRuntime(b["cfg"], backend="ref",
                                conf_backend="pallas_interpret"), b["jp"],
                 iter(samples), JCostModel(num_layers=L, alpha=alpha,
                                           offload=3.0), JConfig(**kw))
    got = serve(DecodeRuntime(b["tcfg"], device="cpu"), b["tp"],
                iter(samples), CostModel(num_layers=L, alpha=alpha,
                                         offload=3.0), ServingConfig(**kw))
    assert got.path == ref.path == "decode"
    for key in ("preds", "arms", "exited"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    assert got.offload_bytes == ref.offload_bytes
    np.testing.assert_allclose(np.asarray(got.rewards),
                               np.asarray(ref.rewards), rtol=0,
                               atol=FLOAT_ATOL)
    for key in DECODE_KEYS:
        np.testing.assert_array_equal(np.asarray(got.decode[key]),
                                      np.asarray(ref.decode[key]),
                                      err_msg=key)
    dec = got.decode
    if policy == "final":
        np.testing.assert_array_equal(dec["realized_depths"], L - 1)
    else:
        assert dec["offloaded_steps"].any()
        assert (dec["exited_steps"] & (dec["realized_depths"] < L - 1)).any()


def _trees_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_trees_equal(a[k], b[k])
                                              for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_final_equals_plain_decode_loop_bitwise(arch):
    """serve(split_policy="final") == a plain full-depth `decode_step`
    loop: tokens, per-step logits and the final cache tree (a hybrid's
    two subtrees), bitwise."""
    b = _bed(arch)
    rt, params, cfg = DecodeRuntime(b["tcfg"], device="cpu"), b["tp"], \
        b["tcfg"]
    B = 4
    samples = _prompts(cfg.vocab_size, B, seed=3)
    rep = serve(rt, params, iter(samples),
                CostModel(num_layers=cfg.num_layers, alpha=0.5),
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
    depths = torch.full((B,), cfg.num_layers - 1)
    for t in range(T):
        lg, _, _, _, pred_fin, _, m_caches = rt.edge_fn(
            params, m_caches, tok, S + t, depths, total)
        assert torch.equal(lg, ref_logits[t])
        tok = pred_fin
    assert _trees_equal(caches, m_caches)
    assert sorted(caches) == (["attn", "ssm"] if cfg.family == "hybrid"
                              else ["attn"])
