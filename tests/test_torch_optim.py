"""Port vs reference: AdamW, the global-norm clip and the LR schedules.

Random parameter and gradient trees, made with numpy, go through the
reference's pure-JAX optimizer and through the port's in-place one.
float32 leaves are held at RTOL (the same float32 arithmetic; the pow of
the bias corrections and the order of the norm's sum may round apart);
a bfloat16 leaf, cast back to bfloat16 after the float32 update,
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched

RTOL = 1e-6
ATOL = 1e-8


def _tree(seed, scale=1.0, bf16=False):
    rng = np.random.default_rng(seed)
    tree = {
        "embed": rng.standard_normal((16, 8)).astype(np.float32) * scale,
        "layers": {"w": rng.standard_normal((3, 8, 8)).astype(np.float32)
                   * scale,
                   "b": rng.standard_normal((3, 8)).astype(np.float32)
                   * scale},
        "exit_w": rng.standard_normal((8, 2)).astype(np.float32) * scale,
    }
    if bf16:
        tree["layers"]["w"] = np.asarray(
            jnp.asarray(tree["layers"]["w"], jnp.bfloat16))
    return tree


def _flat(tree):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else
                          np.asarray(v, np.float32))
            for k, v in tadamw.flatten(tree).items()}


def _close(got, want):
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


def test_adamw_init_mirrors_the_parameter_paths():
    params = params_from_jax(_tree(0, bf16=True), device="cpu")
    state = tadamw.adamw_init(params)
    names = [n for n, _ in params.named_parameters()]
    assert list(state["m"]) == list(state["v"]) == names
    assert state["count"] == 0
    for name, p in params.named_parameters():
        assert state["m"][name].dtype == torch.float32
        assert state["m"][name].shape == p.shape
        assert not state["m"][name].any() and not state["v"][name].any()


@pytest.mark.parametrize("scale,max_norm", [(0.01, 1.0), (3.0, 1.0),
                                            (1.0, 0.5)])
def test_clip_by_global_norm_matches_reference(scale, max_norm):
    grads = _tree(1, scale)
    ref, ref_norm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    tgrads = jax.tree.map(lambda a: tensor_from_numpy(a, "cpu"), grads)
    got, norm = tadamw.clip_by_global_norm(tgrads, max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=RTOL)
    _close({k: v.numpy() for k, v in got.items()},
           _flat(jax.tree.map(np.asarray, ref)))


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_reference(bf16):
    """Four steps from the same parameters with the same gradients, under
    the cosine schedule the train step uses; AdamWConfig defaults plus a
    large-gradient step that the clip scales."""
    cfg_j, cfg_t = jadamw.AdamWConfig(), tadamw.AdamWConfig()
    assert tuple(cfg_j) == tuple(cfg_t)
    jp = jax.tree.map(jnp.asarray, _tree(2, bf16=bf16))
    tp = params_from_jax(_tree(2, bf16=bf16), device="cpu")
    jstate, tstate = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for step, scale in enumerate((0.1, 5.0, 0.3, 0.02)):
        grads = _tree(10 + step, scale)
        lr_j = jsched.cosine_schedule(jstate["count"], 10, 2)
        lr_t = tsched.cosine_schedule(tstate["count"], 10, 2)
        jp, jstate, jnorm = jadamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jstate, cfg_j, lr_j)
        tnorm = tadamw.adamw_update(
            tp, tadamw.flatten(jax.tree.map(
                lambda a: tensor_from_numpy(a, "cpu"), grads)),
            tstate, cfg_t, lr_t)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=RTOL)
        assert tstate["count"] == int(jstate["count"]) == step + 1
        for part in ("m", "v"):
            _close({k: v.numpy() for k, v in tstate[part].items()},
                   _flat(jax.tree.map(np.asarray, jstate[part])))
        want = tadamw.flatten(jax.tree.map(np.asarray, jp))
        for name, p in tp.named_parameters():
            w = np.asarray(want[name], np.float32)
            assert p.dtype == tensor_from_numpy(want[name], "cpu").dtype
            if p.dtype == torch.bfloat16:
                np.testing.assert_array_equal(p.float().numpy(), w)
                continue
            np.testing.assert_allclose(p.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_adamw_first_step_by_hand():
    """One step worked by hand: the decay reads the pre-update parameter
    inside the lr product, p − lr·(m̂/(√v̂ + eps) + wd·p)."""
    tp = params_from_jax({"w": np.full((4,), 2.0, np.float32)}, device="cpu")
    state = tadamw.adamw_init(tp)
    g = {"w": torch.full((4,), 0.5)}
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.5, max_grad_norm=100.0)
    tadamw.adamw_update(tp, g, state, cfg)
    # step 1: m̂ = g, v̂ = g², so m̂/(√v̂+eps) ≈ 1; p = 2 − 0.1·(1 + 0.5·2)
    np.testing.assert_allclose(tp["w"].detach().numpy(), 1.8, rtol=1e-6)


@pytest.mark.parametrize("total,warmup", [(200, 50), (10, 0), (7, 9)])
def test_schedules_match_reference(total, warmup):
    for step in range(0, total + 5):
        np.testing.assert_allclose(
            tsched.linear_warmup(step, warmup),
            float(jsched.linear_warmup(jnp.int32(step), warmup)), rtol=RTOL)
        got = tsched.cosine_schedule(step, total, warmup)
        assert got.dtype == np.float32
        np.testing.assert_allclose(
            got, float(jsched.cosine_schedule(jnp.int32(step), total,
                                              warmup)), rtol=RTOL, atol=ATOL)
