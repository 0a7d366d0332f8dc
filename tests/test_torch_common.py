"""Port vs reference: norms, RoPE, the MLP, configs and the data stream.

Inputs are made with numpy from a seed and fed to both packages; the port
runs on the CPU (its plain PyTorch path). float32 at atol 1e-6, with an
rtol of 1e-6 beside it for outputs above 1, where the two frameworks'
reductions and rsqrt differ by a few ulps.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import OnlineStream, make_dataset, microbatches
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.data import microbatches as t_microbatches
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp

ATOL = 1e-6
RTOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.numpy(),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, 64, scale=3.0) + 0.5
    p = {"scale": _rand(rng, 64, scale=0.1) + 1.0,
         "bias": _rand(rng, 64, scale=0.1)}
    ref = jcommon.apply_norm(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()}, kind)
    got = tcommon.apply_norm(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()},
                             kind)
    _close(ref, got)


def test_layernorm_population_variance_and_eps():
    """jnp.var is the population variance and the eps is 1e-6: a row with
    a tiny spread separates both from torch's defaults."""
    x = np.array([[1.0, 1.0 + 2e-3, 1.0 - 2e-3, 1.0]], np.float32)
    ones, zeros = np.ones(4, np.float32), np.zeros(4, np.float32)
    ref = np.asarray(jcommon.layernorm(jnp.asarray(x), jnp.asarray(ones),
                                       jnp.asarray(zeros)))
    got = tcommon.layernorm(torch.from_numpy(x), torch.from_numpy(ones),
                            torch.from_numpy(zeros)).numpy()
    np.testing.assert_allclose(ref, got, rtol=0, atol=1e-5)
    torch_default = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (4,)).numpy()
    assert np.abs(torch_default - ref).max() > 1e-3


def test_norm_casts_back_to_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    p = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    assert tcommon.apply_norm(x, p, "layernorm").dtype == torch.bfloat16
    assert tcommon.apply_norm(x, p, "rmsnorm").dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 3, 16)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 3, (2, 9)).copy()
    ref = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    _close(ref, got, atol=2e-6)
    np.testing.assert_allclose(np.asarray(jcommon.rope_freqs(16, theta)),
                               tcommon.rope_freqs(16, theta).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("activation", ["gelu_mlp", "swiglu"])
def test_mlp_matches_reference(activation):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 7, 32)
    p = {"wi": _rand(rng, 32, 64, scale=0.2), "wg": _rand(rng, 32, 64, scale=0.2),
         "wo": _rand(rng, 64, 32, scale=0.2)}
    if activation == "gelu_mlp":
        del p["wg"]
    ref = jmlp.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), activation)
    got = tmlp.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), activation)
    _close(ref, got)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True; the port must not use
    torch's exact-erf default (they differ by up to ~4e-4)."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)[:, None]
    eye = np.eye(1, dtype=np.float32)
    p = {"wi": eye, "wo": eye}
    ref = np.asarray(jmlp.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x), "gelu_mlp"))
    got = tmlp.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), "gelu_mlp").numpy()
    np.testing.assert_allclose(ref, got, rtol=0, atol=ATOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


def test_configs_equal_reference():
    ref = get_smoke_config("elasticbert12")
    got = t_get_smoke_config("elasticbert12")
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    full = t_get_config("elasticbert12")
    assert (full.num_layers, full.d_model, full.num_heads, full.d_ff,
            full.vocab_size) == (12, 768, 12, 3072, 30522)
    from repro.configs import get_config
    assert full.param_count() == get_config("elasticbert12").param_count()


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_unported_arch_raises(arch):
    """The VLM and enc-dec archs, once refused, are ported: full and smoke
    configs equal the reference's field by field."""
    from repro.configs import get_config
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    assert dataclasses.asdict(t_get_smoke_config(arch)) == \
        dataclasses.asdict(get_smoke_config(arch))
    assert t_get_config(arch).param_count() == get_config(arch).param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        t_get_config(arch + "-x")


@pytest.mark.parametrize("domain", ["imdb_like", "snli_like"])
def test_dataset_and_stream_bit_identical(domain):
    ref = make_dataset(domain, 50, seed=3)
    got = t_make_dataset(domain, 50, seed=3)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])
        assert ref[k].dtype == got[k].dtype
    ref_batches = list(microbatches(OnlineStream(ref, seed=4), 8, 45))
    got_batches = list(t_microbatches(TStream(got, seed=4), 8, 45))
    assert [len(b) for b in ref_batches] == [len(b) for b in got_batches]
    for rb, gb in zip(ref_batches, got_batches):
        for rs, gs in zip(rb, gb):
            np.testing.assert_array_equal(rs["tokens"], gs["tokens"])
            assert int(rs["labels"]) == int(gs["labels"])
