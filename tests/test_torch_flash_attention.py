"""Port vs reference: block attention and the attention layer.

The port's `attention` on CPU tensors (its plain version) against the
reference's Pallas kernel in interpret mode and its `gqa_ref` oracle, on
the same numpy inputs. float32 at atol 1e-5. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as j_attention
from repro.kernels.flash_attention.ref import gqa_ref as j_gqa_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models import attention as tattn

ATOL = 1e-5

CASES = [
    # b, hq, hkv, sq, skv, d, causal, window
    (2, 4, 4, 64, 64, 32, False, 0),     # bidirectional (ElasticBERT)
    (1, 4, 4, 40, 40, 32, True, 0),      # causal, ragged tile
    (1, 2, 2, 48, 48, 16, True, 8),      # sliding window
    (2, 4, 2, 32, 32, 16, True, 0),      # GQA
    (1, 2, 1, 5, 37, 16, True, 0),       # suffix queries, Sq < Skv, GQA
    (1, 2, 2, 7, 50, 32, False, 0),      # suffix queries, bidirectional
]


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES)
def test_attention_matches_reference(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _qkv(sq * 7 + skv, b, hq, hkv, sq, skv, d)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_kernel = np.asarray(j_attention(jq, jk, jv, causal=causal,
                                        window=window,
                                        backend="pallas_interpret",
                                        block_q=32, block_k=32))
    ref_oracle = np.asarray(j_gqa_ref(jq, jk, jv, causal=causal,
                                      window=window))
    np.testing.assert_allclose(got, ref_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref_oracle, rtol=0, atol=ATOL)


def test_attention_rejects_unknown_device():
    q = torch.empty((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        attention(q, q, q)


@pytest.mark.parametrize("num_kv_heads", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_prefill_matches_reference(num_kv_heads, causal):
    """Projection, RoPE, attention and output projection of one layer."""
    rng = np.random.default_rng(5)
    d, heads, hd, b, s = 64, 4, 16, 2, 24
    p = {"wq": rng.standard_normal((d, heads * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, num_kv_heads * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, num_kv_heads * hd)) * d ** -0.5,
         "wo": rng.standard_normal((heads * hd, d)) * (heads * hd) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kw = dict(num_heads=heads, num_kv_heads=num_kv_heads, head_dim=hd,
              causal=causal, window=0, rope_theta=10000.0)
    ref = jattn.attn_prefill({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jnp.asarray(pos),
                             backend="pallas_interpret", **kw)
    got = tattn.attn_prefill({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0,
                               atol=ATOL)
