"""Port vs reference: the offload codec, bit for bit.

The port's `OffloadCodec` works in torch ops on the rows' own device; the
reference's in host numpy. On the same rows (float32 and bfloat16, made
with numpy and handed to both) every mode must give the same encoded
payload (values, per-channel scale/zero, kept indices), the same decoded
rows and the same error-feedback residuals, bitwise; the measured wire
bytes equal the closed form `row_bytes`. Served through the codec
(sequential, batched bucketed and scan), the port takes the reference's
decisions (arms, exits, preds) and ships the same offload bytes.
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
from repro.models.transformer import forward_exits, init_params
from repro.serving.api import ServingConfig as JConfig
from repro.serving.api import serve as jserve
from repro.serving.offload_codec import OffloadCodec as JCodec
from repro.serving.offload_codec import codec_from_fields as j_codec_from_fields
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.serving import (EdgeCloudRuntime, EncodedRows, OffloadCodec,
                                 ServingConfig, serve)
from repro_torch.serving.offload_codec import QUANT_MODES, codec_from_fields

MODES = [("none", 0.5), ("int8", 0.0), ("int8", 0.3), ("int4", 0.0),
         ("int4", 0.5)]
SHAPES = [(3, 16, 32), (2, 7, 33)]          # (2, 7, 33): odd m for int4
DTYPES = ["float32", "bfloat16"]


def _rows(shape, dtype, seed=0):
    """numpy rows with exact zeros of both signs and (in bf16) many equal
    magnitudes, so the stable top-k order is exercised."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, :4] = 0.0
    x[0, 1, :4] = -0.0
    x[-1, -1, :3] = x[-1, -1, 3]            # a tie of equal values
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _bits(a):
    """numpy array or tensor -> its bits as a numpy integer array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.contiguous().view(torch.int16).numpy()
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _assert_bitwise(got, want, what):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("quant,sparsity", MODES)
def test_codec_matches_reference_bitwise(quant, sparsity, shape, dtype):
    rows = _rows(shape, dtype)
    ref, got = JCodec(quant, sparsity), OffloadCodec(quant, sparsity)
    enc_r = ref.encode(rows)
    enc_g = got.encode(tensor_from_numpy(rows, "cpu"))
    assert isinstance(enc_g, EncodedRows) and enc_g.shape == enc_r.shape
    for part in ("data", "scale", "zero", "index"):
        a, b = getattr(enc_g, part), getattr(enc_r, part)
        assert (a is None) == (b is None), part
        if a is not None:
            _assert_bitwise(a, b, part)
    _assert_bitwise(got.decode(enc_g), ref.decode(enc_r), "decode")
    s, d = shape[1:]
    itemsize = 2 if dtype == "bfloat16" else 4
    assert enc_g.row_bytes == enc_r.row_bytes \
        == got.row_bytes(s, d, itemsize) == ref.row_bytes(s, d, itemsize)
    assert enc_g.nbytes == enc_r.nbytes
    assert got.cost_ratio(s, d, itemsize) == ref.cost_ratio(s, d, itemsize)
    assert got.kept(s, d) == ref.kept(s, d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant,sparsity", MODES)
def test_error_feedback_matches_reference_over_rounds(quant, sparsity, dtype):
    ref, got = JCodec(quant, sparsity, True), OffloadCodec(quant, sparsity,
                                                            True)
    shape = (2, 8, 16)
    res_r = np.zeros(shape, np.float32)
    res_g = torch.zeros(shape)
    for rnd in range(3):
        rows = _rows(shape, dtype, seed=rnd)
        _, dec_r, res_r = ref.encode_with_feedback(rows, res_r)
        _, dec_g, res_g = got.encode_with_feedback(
            tensor_from_numpy(rows, "cpu"), res_g)
        _assert_bitwise(dec_g, dec_r, f"round {rnd} decode")
        _assert_bitwise(res_g, res_r, f"round {rnd} residual")


def test_lossless_modes_and_identity():
    rows = torch.as_tensor(_rows((2, 4, 8), "float32"))
    assert codec_from_fields("none", 0.0) is None
    assert j_codec_from_fields("none", 0.0) is None
    assert codec_from_fields("int8", 0.0) == OffloadCodec("int8")
    assert QUANT_MODES == ("none", "int8", "int4")
    assert OffloadCodec().identity and not OffloadCodec("int4").identity
    enc, dec, res = OffloadCodec(error_feedback=True).encode_with_feedback(
        rows, torch.zeros_like(rows))
    assert torch.equal(dec, rows) and not res.any()
    for bad in (dict(quant="int2"), dict(sparsity=1.0),
                dict(sparsity=-0.1)):
        with pytest.raises(ValueError) as got:
            OffloadCodec(**bad)
        with pytest.raises(ValueError) as want:
            JCodec(**bad)
        assert str(got.value) == str(want.value)


def test_sparse_decode_keeps_the_largest_and_zeroes_the_rest():
    rows = torch.as_tensor(_rows((2, 8, 16), "float32"))
    codec = OffloadCodec("none", 0.75)
    dec = codec.decode(codec.encode(rows))
    kept = codec.kept(8, 16)
    assert kept == 32
    for r in range(2):
        nz = dec[r].flatten() != 0
        assert int(nz.sum()) <= kept
        # every kept magnitude is >= every dropped one
        mags = rows[r].abs().flatten()
        assert mags[nz].min() >= mags[~nz].max()


# ---------------------------------------------------- codec serving

N_SAMPLES = 37
ALPHA_MARGIN = 1e-4


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(get_smoke_config("elasticbert12"),
                              dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config("elasticbert12"),
                               dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    data = make_dataset("imdb_like", N_SAMPLES, seed=1)
    conf = np.sort(np.asarray(forward_exits(
        jp, cfg, {"tokens": jnp.asarray(data["tokens"])})["conf"]).ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    alpha = float(conf[k] + conf[k + 1]) / 2
    assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
    return cfg, tcfg, jp, tp, alpha


@pytest.mark.parametrize("batch_size,edge_mode,quant,sparsity", [
    (1, "bucketed", "int8", 0.0),           # the sequential path
    (8, "bucketed", "int8", 0.0),
    (8, "scan", "int4", 0.5),
    (8, "bucketed", "none", 0.5),
])
def test_codec_serving_matches_reference(served, batch_size, edge_mode,
                                         quant, sparsity):
    cfg, tcfg, jp, tp, alpha = served
    kw = dict(batch_size=batch_size, edge_mode=edge_mode,
              offload_quant=quant, offload_sparsity=sparsity)
    ref = jserve(JRuntime(cfg, backend="ref",
                          conf_backend="pallas_interpret"), jp,
                 OnlineStream(make_dataset("imdb_like", N_SAMPLES, seed=1),
                              seed=0),
                 JCostModel(num_layers=cfg.num_layers, alpha=alpha,
                            offload=3.0), JConfig(**kw))
    got = serve(EdgeCloudRuntime(tcfg, device="cpu"), tp,
                TStream(t_make_dataset("imdb_like", N_SAMPLES, seed=1),
                        seed=0),
                CostModel(num_layers=tcfg.num_layers, alpha=alpha,
                          offload=3.0), ServingConfig(**kw))
    assert got.path == ref.path == ("sequential" if batch_size == 1
                                    else "batched")
    for key in ("arms", "exited", "preds"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got.offload_bytes == ref.offload_bytes > 0
    offloads = int(got.n - got.exited.sum())
    assert got.offload_bytes == offloads * OffloadCodec(
        quant, sparsity).row_bytes(64, tcfg.d_model, 4)
    # cost depends on arms and exits alone; the rewards read the cloud's
    # confidences, and a last-bit difference of the two frameworks' edge
    # hidden can move a value across a rounding boundary of the int grid,
    # so they are not compared here (the codec itself is bitwise above)
    assert abs(got.cost_total - ref.cost_total) <= 1e-6
    assert 0 < ref.exited.sum() < N_SAMPLES
