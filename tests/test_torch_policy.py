"""Port vs reference: the paper's offline bandit simulators, regret,
baselines, alpha calibration and the exit-profile simulators.

The port runs them in numpy float32 on the host. Both sides read the same
numpy confidences; where the reference draws with ``jax.random`` (the
permutations of ``run_many``, the random baselines), the port is given
the reference's own draws. ``run_stream`` and ``run_many`` are held bit
for bit (the port rounds as XLA compiles the reference's scan), as are
the profile simulators. Elsewhere arms, exits, accuracies and alphas
are held exactly; one jitted ``bandit_step``'s reward and cost and those of the
vmapped ``run_many``, which XLA rounds apart from the scan, and the
baselines' costs at RTOL with
ATOL (one float32 ulp of the O(1) terms a reward is the difference of);
regret, a running float32 sum over N terms taken in another order, at
REGRET_RTOL (2·N·eps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baselines as jbase
from repro.core import policy as jpol
from repro.core import regret as jreg
from repro.core.rewards import CostModel as JCost
from repro.core.thresholds import calibrate_alpha as j_calibrate
from repro.data import profiles as jprof
from repro_torch.core import baselines as tbase
from repro_torch.core import policy as tpol
from repro_torch.core import regret as treg
from repro_torch.core.rewards import CostModel as TCost
from repro_torch.core.thresholds import calibrate_alpha as t_calibrate
from repro_torch.data import profiles as tprof

RTOL = 1e-6
ATOL = 1e-7
REGRET_RTOL = 2e-4
L = 12
N = 1500


def _costs(alpha=0.8, offload=5.0):
    return (JCost(num_layers=L, alpha=alpha, offload=offload),
            TCost(num_layers=L, alpha=alpha, offload=offload))


@pytest.fixture(scope="module")
def stream():
    prof = jprof.simulate_exit_profiles(jprof.PROFILE_DATASETS["imdb"],
                                        seed=3, subsample=N)
    return prof["conf"], prof["correct"]


def test_log_f32_is_xla_log():
    t = np.arange(1, 200_001, dtype=np.float32)
    np.testing.assert_array_equal(tpol.log_f32(t),
                                  np.asarray(jax.jit(jnp.log)(t)))


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_ucb_index_and_select_arm_match_reference(beta):
    rng = np.random.default_rng(4)
    for t in (0, 5, 12, 13, 977, 123457):
        n = rng.integers(0, 50, L).astype(np.float32)
        q = rng.random(L).astype(np.float32)
        js = jpol.BanditState(jnp.asarray(q), jnp.asarray(n), jnp.int32(t))
        ts = tpol.BanditState(q, n, t)
        np.testing.assert_array_equal(tpol.ucb_index(ts, beta),
                                      np.asarray(jpol.ucb_index(js, beta)))
        assert tpol.select_arm(ts, L, beta) == int(
            jpol.select_arm(js, L, beta))


@pytest.mark.parametrize("side_info", [False, True])
def test_bandit_step_matches_reference(stream, side_info):
    conf, _ = stream
    jc, tc = _costs()
    js, ts = jpol.init_state(L), tpol.init_state(L)
    for t in range(40):                 # round robin, then UCB
        js, jinfo = jpol.bandit_step(js, jnp.asarray(conf[t]), cost=jc,
                                     side_info=side_info)
        ts, tinfo = tpol.bandit_step(ts, conf[t], cost=tc,
                                     side_info=side_info)
        assert int(tinfo["arm"]) == int(jinfo["arm"])
        assert bool(tinfo["exited"]) == bool(jinfo["exited"])
        for key in ("reward", "cost", "conf"):
            np.testing.assert_allclose(tinfo[key], np.asarray(jinfo[key]),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts.q, np.asarray(js.q), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(ts.n, np.asarray(js.n))
        assert ts.t == int(js.t)


@pytest.mark.parametrize("side_info", [False, True])
@pytest.mark.parametrize("beta", [1.0, 0.5, 0.7])
def test_run_stream_matches_reference(stream, side_info, beta):
    conf, _ = stream
    jc, tc = _costs()
    ref = jpol.run_stream(jnp.asarray(conf), cost=jc, beta=beta,
                          side_info=side_info)
    got = tpol.run_stream(conf, cost=tc, beta=beta, side_info=side_info)
    for key in ("arm", "exited", "reward", "cost", "conf"):
        assert got[key].dtype == np.asarray(ref[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    # every arm pulled, both exits and offloads: the stream exercises UCB
    assert len(np.unique(got["arm"])) == L
    assert 0 < got["exited"].sum() < N


@pytest.mark.parametrize("side_info", [False, True])
def test_run_many_with_reference_permutations(stream, side_info):
    """Given the reference's own permutations, every run equals the
    reference's run (its arms and exits exactly; its rewards and costs at
    RTOL, since XLA rounds the vmapped scan's reward apart from the
    scan's) and, bit for bit, the port's `run_stream` of that permuted
    stream."""
    conf = stream[0][:400]
    jc, tc = _costs()
    ref = jpol.run_many(jnp.asarray(conf), jax.random.PRNGKey(7), cost=jc,
                        side_info=side_info, num_runs=4)
    perms = np.asarray(ref["perm"])
    got = tpol._run_permuted(conf, perms, cost=tc, side_info=side_info)
    for key in ("arm", "exited", "conf"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    for key in ("reward", "cost"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=RTOL,
                                   atol=ATOL)
    for r in range(len(perms)):
        one = tpol.run_stream(conf[perms[r]], cost=tc, side_info=side_info)
        for key, val in one.items():
            np.testing.assert_array_equal(got[key][r], val)


def test_run_many_draws_permutations_from_the_generator(stream):
    conf = stream[0][:300]
    _, tc = _costs()
    out = tpol.run_many(conf, np.random.default_rng(5), cost=tc, num_runs=3)
    assert out["perm"].shape == (3, 300) and out["arm"].shape == (3, 300)
    for perm in out["perm"]:
        np.testing.assert_array_equal(np.sort(perm), np.arange(300))
    again = tpol._run_permuted(conf, out["perm"], cost=tc)
    for key, val in again.items():
        np.testing.assert_array_equal(out[key], val)
    same_seed = tpol.run_many(conf, np.random.default_rng(5), cost=tc,
                              num_runs=3)
    np.testing.assert_array_equal(same_seed["perm"], out["perm"])


@pytest.mark.parametrize("side_info", [False, True])
def test_regret_matches_reference(stream, side_info):
    conf, correct = stream
    jc, tc = _costs()
    np.testing.assert_allclose(
        treg.per_sample_rewards(conf, tc, side_info=side_info),
        np.asarray(jreg.per_sample_rewards(jnp.asarray(conf), jc,
                                           side_info=side_info)),
        rtol=RTOL, atol=ATOL)
    arms = tpol.run_stream(conf, cost=tc, side_info=side_info)["arm"]
    got = treg.cumulative_regret(conf, arms, tc, side_info=side_info)
    ref = np.asarray(jreg.cumulative_regret(jnp.asarray(conf),
                                            jnp.asarray(arms), jc,
                                            side_info=side_info))
    assert got.dtype == np.float32 and got.shape == (N,)
    np.testing.assert_allclose(got, ref, rtol=REGRET_RTOL)
    om_t = treg.oracle_policy_metrics(conf, correct, tc, side_info=side_info)
    om_j = jreg.oracle_policy_metrics(jnp.asarray(conf),
                                      jnp.asarray(correct), jc,
                                      side_info=side_info)
    assert om_t["arm"] == int(om_j["arm"])
    np.testing.assert_allclose(om_t["acc"], float(om_j["acc"]), rtol=RTOL)
    np.testing.assert_allclose(om_t["cost"], float(om_j["cost"]),
                               rtol=RTOL)


def test_baselines_match_reference_given_its_draws(stream):
    conf, correct = stream
    jc, tc = _costs()
    jconf, jcorr = jnp.asarray(conf), jnp.asarray(correct)
    for (ta, tcost), (ja, jcost) in (
            (tbase.final_exit(conf, correct, tc),
             jbase.final_exit(jconf, jcorr, jc)),
            (tbase.confidence_cascade(conf, correct, tc),
             jbase.confidence_cascade(jconf, jcorr, jc)),
            (tbase.confidence_cascade(conf, correct, tc, threshold=0.9),
             jbase.confidence_cascade(jconf, jcorr, jc, threshold=0.9))):
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_allclose(tcost, np.asarray(jcost), rtol=RTOL,
                                   atol=ATOL)

    key = jax.random.PRNGKey(11)
    arms = np.asarray(jax.random.randint(key, (N,), 0, L))
    ta, tcost = tbase.random_exit_arms(conf, correct, tc, arms)
    ja, jcost = jbase.random_exit(jconf, jcorr, jc, key)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(tcost, np.asarray(jcost), rtol=RTOL,
                               atol=ATOL)

    # deebert draws both arrays from one key (the reference's quirk)
    normal = np.asarray(jax.random.normal(key, conf.shape))
    uniform = np.asarray(jax.random.uniform(key, conf.shape))
    for miscalib in (0.15, 0.3):
        ta, tcost = tbase.deebert_cascade_draws(conf, correct, tc, normal,
                                                uniform, miscalib=miscalib)
        ja, jcost = jbase.deebert_cascade(jconf, jcorr, jc, key,
                                          miscalib=miscalib)
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_allclose(tcost, np.asarray(jcost), rtol=RTOL,
                                   atol=ATOL)


def test_random_baselines_draw_from_the_generator(stream):
    conf, correct = stream
    _, tc = _costs()
    acc, cost = tbase.random_exit(conf, correct, tc,
                                  np.random.default_rng(1))
    arms = np.random.default_rng(1).integers(0, L, N)
    want = tbase.random_exit_arms(conf, correct, tc, arms)
    np.testing.assert_array_equal(acc, want[0])
    np.testing.assert_array_equal(cost, want[1])
    acc, cost = tbase.deebert_cascade(conf, correct, tc,
                                      np.random.default_rng(2))
    assert acc.shape == cost.shape == (N,) and acc.dtype == np.float32
    seed = int(np.random.default_rng(2).integers(2 ** 63))
    normal = np.random.default_rng(seed).standard_normal(conf.shape)
    uniform = np.random.default_rng(seed).random(conf.shape)
    want = tbase.deebert_cascade_draws(conf, correct, tc, normal, uniform)
    np.testing.assert_array_equal(acc, want[0])
    np.testing.assert_array_equal(cost, want[1])


@pytest.mark.parametrize("side_info", [False, True])
@pytest.mark.parametrize("name", ["imdb", "qqp", "scitail"])
def test_calibrate_alpha_matches_reference(name, side_info):
    prof = jprof.simulate_exit_profiles(jprof.PROFILE_DATASETS[name], seed=1,
                                        subsample=2500)
    conf, correct = prof["conf"], prof["correct"]
    jc, tc = _costs(offload=3.0)
    assert t_calibrate(conf, tc, side_info=side_info) == j_calibrate(
        jnp.asarray(conf), jc, side_info=side_info)
    assert t_calibrate(conf, tc, correct, side_info=side_info) == \
        j_calibrate(jnp.asarray(conf), jc, correct, side_info=side_info)
    grid = np.linspace(0.6, 0.95, 8)
    assert t_calibrate(conf, tc, correct, grid=grid, max_acc_drop=0.0) == \
        j_calibrate(jnp.asarray(conf), jc, correct, grid=grid,
                    max_acc_drop=0.0)


@pytest.mark.parametrize("name", sorted(jprof.PROFILE_DATASETS))
def test_exit_profiles_bitwise_equal_reference(name):
    spec_j = jprof.PROFILE_DATASETS[name]
    spec_t = tprof.PROFILE_DATASETS[name]
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    assert spec_t.hard_final == spec_j.hard_final
    for seed in (0, 4):
        ref = jprof.simulate_exit_profiles(spec_j, seed=seed, subsample=3000)
        got = tprof.simulate_exit_profiles(spec_t, seed=seed, subsample=3000)
        for key in ("conf", "correct"):
            assert got[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(got[key], ref[key])


def test_drift_profiles_bitwise_equal_reference():
    def spec(mod):
        ds = mod.PROFILE_DATASETS
        return mod.DriftSpec("imdb_to_qqp", ((700, ds["imdb"]),
                                             (500, ds["qqp"]),
                                             (300, ds["snli"])))
    ref = jprof.simulate_drift_profiles(spec(jprof), seed=2)
    got = tprof.simulate_drift_profiles(spec(tprof), seed=2)
    for key in ("conf", "correct", "boundaries"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got["segments"] == ref["segments"] == ["imdb", "qqp", "snli"]
    assert spec(tprof).boundaries == (700, 1200) and spec(tprof).n == 1500
    with pytest.raises(ValueError, match="must be positive"):
        tprof.DriftSpec("bad", ((0, tprof.PROFILE_DATASETS["imdb"]),))
