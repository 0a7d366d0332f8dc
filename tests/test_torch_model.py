"""Port vs reference: parameter bridge, layer and multi-exit forward.

The reference's `init_params` is bridged into the port (numpy leaves),
so both sides compute with the same weights: conf at atol 1e-5, pred
exactly equal. float32 smoke ElasticBERT (2 layers, d 128, 4 heads).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import transformer as jtf
from repro.data import make_dataset
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import transformer as ttf

CONF_ATOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    cfg = dataclasses.replace(get_smoke_config("elasticbert12"),
                              dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                               dtype="float32")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def test_param_names_are_reference_paths(bridged):
    _, tcfg, jp, tp = bridged
    want = _paths(jax.tree.map(np.asarray, jp))
    got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    assert got == want
    assert tp["layers"]["exit_w"].shape == (tcfg.num_layers, tcfg.d_model,
                                            tcfg.num_classes)
    assert not any(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_layout(dtype):
    """Same paths, shapes and dtypes as the reference's init, from a
    seeded torch.Generator; the same seed gives the same draws."""
    cfg = dataclasses.replace(get_smoke_config("elasticbert12"), dtype=dtype)
    tcfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                               dtype=dtype)
    want = _paths(jtf.abstract_params(cfg))
    tp = ttf.init_params(tcfg, seed=3, device="cpu")
    got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    assert got == want
    assert all(p.dtype == getattr(torch, dtype) for p in tp.parameters())
    again = ttf.init_params(tcfg, seed=3, device="cpu")
    for (_, a), (_, b) in zip(tp.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b)


def test_bridge_bfloat16_is_bit_exact():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    tp = params_from_jax({"w": a}, device="cpu")
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  a.astype(np.float32))


def test_layer_full_matches_reference(bridged):
    cfg, tcfg, jp, tp = bridged
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    lp = jax.tree.map(lambda a: a[1], jp["layers"])
    ref, _ = jtf._layer_full(cfg, jp, lp, jnp.asarray(x), jnp.asarray(pos),
                             1, window=0, backend="pallas_interpret")
    got, _ = ttf._layer_full(tcfg, tp, ttf.layer_params(tp["layers"], 1),
                             torch.from_numpy(x), torch.from_numpy(pos), 1,
                             window=0)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0,
                               atol=2e-5)


def test_forward_exits_matches_reference(bridged):
    cfg, tcfg, jp, tp = bridged
    toks = make_dataset("imdb_like", 12, seed=1)["tokens"]
    ref = jtf.forward_exits(jp, cfg, {"tokens": jnp.asarray(toks)},
                            backend="pallas_interpret",
                            conf_backend="pallas_interpret")
    got = ttf.forward_exits(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(np.asarray(ref["conf"]), got["conf"].numpy(),
                               rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(np.asarray(ref["pred"]),
                                  got["pred"].numpy())
    np.testing.assert_allclose(np.asarray(ref["hidden"]),
                               got["hidden"].numpy(), rtol=0, atol=1e-4)


def test_other_families_not_ported(bridged):
    """The VLM family, once refused, is ported: ElasticBERT's smoke stack
    as a VLM with M-RoPE gives the reference's exits on the same weights
    (token ids and an embeds batch), and an unknown family raises."""
    cfg, tcfg, jp, tp = bridged
    jcfg = dataclasses.replace(cfg, family="vlm", mrope=True)
    vcfg = dataclasses.replace(tcfg, family="vlm", mrope=True)
    toks = np.asarray(make_dataset("sst2_like", 4, seed=1)["tokens"])
    emb = np.random.default_rng(2).normal(
        0, 1, toks.shape + (cfg.d_model,)).astype(np.float32)
    for jb, tb in (({"tokens": jnp.asarray(toks)},
                    {"tokens": torch.from_numpy(toks)}),
                   ({"embeds": jnp.asarray(emb)},
                    {"embeds": torch.from_numpy(emb)})):
        ref = jtf.forward_exits(jp, jcfg, jb)
        with torch.no_grad():
            got = ttf.forward_exits(tp, vcfg, tb)
        np.testing.assert_allclose(got["conf"].numpy(),
                                   np.asarray(ref["conf"]), rtol=0,
                                   atol=CONF_ATOL)
        np.testing.assert_array_equal(got["pred"].numpy(),
                                      np.asarray(ref["pred"]))
    assert sorted(dict(ttf.init_params(vcfg, device="cpu")
                       .named_parameters())) == sorted(_paths(jp))
    with pytest.raises(NotImplementedError, match="is unknown"):
        ttf.init_params(dataclasses.replace(tcfg, family="vision"),
                        device="cpu")
