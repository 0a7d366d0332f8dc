"""Port vs reference: the distributed serving runtime (serving/distributed.py).

* the host-update wire payload: the port's bytes decode in the
  reference's ``_unpack_host_update`` and the other way round;
* the fault-tolerant exchange protocol with hosts as threads, over a
  `FileKV` directory and over a TCPStore served in this process (the
  reference's in-process tests): gather round-trip and GC, a dropped
  write fences its host, freeze vs slow, arbiter failover, the rejoin
  handshake; the lockstep `CoordinatorExchange`: GC one round behind,
  distinct epoch namespaces, a close barrier that times out cleanly;
* one host: ``serve(path="distributed")`` equals the reference's
  ``serve(path="distributed")`` on the same bridged weights (decisions
  exactly, floats within 1e-6) and the port's sharded R = 1 run bit for
  bit, at overlap off, K = 1 and K = 2, and fault-tolerant over FileKV;
* 2 and 3 hosts as threads (lockstep over a TCPStore, fault-tolerant
  over FileKV) against the reference's single-process sharded run:
  decisions exactly, rewards and q within rtol = atol = 1e-6 (the
  frameworks' floats differ in the last bits); against the port's own
  one-process run, every mirror bit for bit (on the CPU, one intra-op
  thread: the slices' smaller calls give the rows the same bits);
* three subprocess clusters through `run_supervised_cluster` (CPU
  workers, one thread each): 2 processes in lockstep over the TCPStore,
  the 3 -> 2 kill invariant (survivors from the epoch after the failure
  == a 2-process run seeded with the merged state, bit for bit), and a
  respawned worker's rejoin; the supervisor's watchdog staleness and the
  argv relay of `respawn_distributed` / `drive_respawned_cluster`.
"""
import base64
import dataclasses
import glob
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import CostModel as JCostModel
from repro.core import SplitEEController as JController
from repro.data import OnlineStream, make_dataset
from repro.data.synthetic import VOCAB
from repro.models.transformer import forward_exits, init_params
from repro.serving import distributed as jdist
from repro.serving.api import ServingConfig as JConfig
from repro.serving.api import serve as jserve
from repro.serving.simulator import EdgeCloudRuntime as JRuntime
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import CostModel, SplitEEController
from repro_torch.core.controller import state_to_bytes
from repro_torch.data import OnlineStream as TStream
from repro_torch.data import make_dataset as t_make_dataset
from repro_torch.serving import (FAULT_KILL_EXIT, EdgeCloudRuntime,
                                 FencedHostError, FileKV, ResilientExchange,
                                 ServingConfig, run_supervised_cluster, serve)
from repro_torch.serving import distributed as tdist
from repro_torch.serving.faults import FaultInjector, parse_fault_plan
from repro_torch.serving.kvstore import CoordinatorKV, KVTimeout, open_tcp_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
N_SAMPLES = 97          # a ragged tail of 1: fewer rows than hosts
BATCH = 16
ALPHA_MARGIN = 1e-4
# floats against another run: rtol 1e-6 beside the sharded suite's atol
# 1e-6 (a reward near zero has no useful relative error)
FLOAT_RTOL = 1e-6
FLOAT_ATOL = 1e-6
WALL_FIELDS = ("wall_s", "samples_per_sec")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread under the suite's parallel workers (see
    tests/test_torch_sharded.py); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_hosts(fns, timeout=60):
    """Run one callable per host concurrently; return their exceptions."""
    errs = [None] * len(fns)

    def wrap(i):
        try:
            fns[i]()
        except BaseException as e:     # noqa: BLE001 — surfaced below
            errs[i] = e

    threads = [threading.Thread(target=wrap, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "host thread wedged"
    return errs


# ------------------------------------------------------------- wire format

def _shard_pair(seed):
    """The same update prepared by both packages' controllers."""
    rng = np.random.default_rng(seed)
    L, B = 5, 7
    arms = rng.integers(0, L, B)
    paths = [rng.uniform(0.05, 0.99, 1) for _ in arms]
    conf_L = [None if rng.random() < 0.5 else float(rng.uniform(0.3, 0.99))
              for _ in arms]
    obs = [int(x) for x in rng.integers(0, 10_000, B)]
    preds = rng.integers(0, 2, B)
    shards = [ctl(cost(num_layers=L, alpha=0.7, offload=4.0))
              .prepare_shard_update(arms, paths, conf_L, obs, round=3)
              for ctl, cost in ((SplitEEController, CostModel),
                                (JController, JCostModel))]
    return shards, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_update_bytes_decode_across_packages(seed):
    (tshard, jshard), preds = _shard_pair(seed)
    for pack, unpack, shard in (
            (tdist._pack_host_update, jdist._unpack_host_update, tshard),
            (jdist._pack_host_update, tdist._unpack_host_update, jshard)):
        raw = pack(shard, preds)
        back, back_preds = unpack(raw)
        for field in ("arms", "rewards", "exited", "costs", "offload_bytes"):
            a, b = getattr(back, field), getattr(shard, field)
            assert np.asarray(a).dtype == np.asarray(b).dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(back_preds, preds)
    assert tdist._pack_host_update(tshard, preds) == \
        tdist._pack_host_update(jshard, preds)


def test_env_names_match_reference():
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                 "ENV_KV_DIR", "ENV_REJOIN", "ENV_WORKER_HEARTBEAT"):
        assert getattr(tdist, name) == getattr(jdist, name), name


def test_cluster_identity_from_env(monkeypatch):
    for var in ("SPLITEE_PROCESS_ID", "SPLITEE_NUM_PROCESSES",
                "SPLITEE_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.cluster_identity() == (0, 1)
    monkeypatch.setenv("SPLITEE_PROCESS_ID", "2")
    monkeypatch.setenv("SPLITEE_NUM_PROCESSES", "3")
    assert tdist.cluster_identity() == (2, 3)
    assert tdist.init_distributed_from_env() is False   # FileKV cluster
    with pytest.raises(RuntimeError, match="init_distributed_from_env"):
        tdist.CoordinatorExchange()


# -------------------------------------------------------- exchange protocol

@pytest.fixture(params=["file", "tcp"])
def transport(request, tmp_path):
    """A factory of KV handles on one fresh namespace: a directory, or a
    TCPStore server in this process with a client per handle."""
    if request.param == "file":
        return lambda: FileKV(str(tmp_path / "kv"))
    server = open_tcp_store("localhost", 0, is_master=True, timeout_s=30)
    return lambda: CoordinatorKV(open_tcp_store(
        "localhost", server.port, is_master=False, timeout_s=30))


def _mk_exchange(kv, host, n, **kw):
    kw.setdefault("heartbeat_timeout", 1.0)
    kw.setdefault("heartbeat_interval", 0.1)
    kw.setdefault("poll_interval", 0.02)
    kw.setdefault("verdict_timeout", 30.0)
    return ResilientExchange(kv, host_id=host, num_hosts=n, epoch=0, **kw)


def test_resilient_gather_roundtrip_and_gc(transport):
    """Payloads round-trip in host order; round keys are GC'd one round
    behind; close() removes the final round's keys."""
    exs = [_mk_exchange(transport(), h, 2) for h in range(2)]
    got = {}

    def host(h):
        def run():
            for r in range(3):
                res = exs[h].gather(f"p{r}-{h}".encode())
                got[(h, r)] = (res.payloads, res.fold, res.members)
                if r > 0:
                    # my previous round's key went with this gather
                    assert exs[h].kv.try_get(exs[h]._pkey(r - 1, h)) is None
            exs[h].close()
        return run

    assert _run_hosts([host(0), host(1)]) == [None, None]
    for h in range(2):
        for r in range(3):
            payloads, fold, members = got[(h, r)]
            assert payloads == [f"p{r}-0".encode(), f"p{r}-1".encode()]
            assert fold == [0, 1] and members == [0, 1]
    probe = transport()
    for r in range(3):
        for h in range(2):
            assert probe.try_get(exs[0]._pkey(r, h)) is None
        assert probe.try_get(exs[0]._vkey(r)) is None


def test_drop_kv_write_fences_host(transport):
    """A host whose round payload never reaches the store is declared
    dead by the arbiter and fences itself when it reads the verdict;
    the survivor re-slices and finishes."""
    inj = FaultInjector(parse_fault_plan("drop_kv:host=1,epoch=1"), 1)
    ex0 = _mk_exchange(transport(), 0, 2)
    ex1 = _mk_exchange(transport(), 1, 2, injector=inj)
    res0 = []

    def host0():
        for r in range(3):
            res0.append(ex0.gather(b"a%d" % r))
        ex0.close()

    def host1():
        ex1.gather(b"b0")
        with pytest.raises(FencedHostError):
            ex1.gather(b"b1")
        ex1.close()

    assert _run_hosts([host0, host1]) == [None, None]
    assert res0[0].fold == [0, 1]
    assert res0[1].fold == [0] and res0[1].removed == [1]
    assert res0[2].fold == [0] and res0[2].members == [0]
    assert ex0.reconfigurations[0]["round"] == 1
    assert ex0.reconfigurations[0]["removed"] == [1]
    # detection bounded by the heartbeat timeout (1 s), with room for the
    # suite's parallel workers: 2 x timeout + 2 s
    assert ex0.reconfigurations[0]["detect_s"] < 2 * 1.0 + 2.0


def test_freeze_is_removed_but_slow_is_not(transport):
    """The slow-vs-dead discrimination: a frozen host (heartbeat paused
    past the timeout) is removed; a merely slow host (heartbeat alive)
    is waited for and folds normally."""
    frozen = FaultInjector(parse_fault_plan("freeze:host=1,epoch=1,secs=3.0"),
                           1)
    ex0 = _mk_exchange(transport(), 0, 2)
    ex1 = _mk_exchange(transport(), 1, 2, injector=frozen)
    res0 = []

    def host0():
        for r in range(2):
            res0.append(ex0.gather(b"a%d" % r))
        ex0.close()

    def host1():
        ex1.gather(b"b0")
        with pytest.raises(FencedHostError):
            ex1.gather(b"b1")     # wakes from the freeze already fenced
        ex1.close()

    assert _run_hosts([host0, host1]) == [None, None]
    assert res0[1].removed == [1]

    slow = FaultInjector(parse_fault_plan("sleep:host=1,epoch=1,secs=1.5"), 1)
    ey0 = _mk_exchange(transport(), 0, 2, prefix="splitee/slow")
    ey1 = _mk_exchange(transport(), 1, 2, prefix="splitee/slow",
                       injector=slow)
    out = []

    def s0():
        for r in range(2):
            out.append(ey0.gather(b"a%d" % r))
        ey0.close()

    def s1():
        for r in range(2):
            ey1.gather(b"b%d" % r)
        ey1.close()

    assert _run_hosts([s0, s1]) == [None, None]
    assert out[1].fold == [0, 1] and out[1].removed == []
    assert ey0.reconfigurations == []


def test_arbiter_failover(transport):
    """If the arbiter itself dies, the next-ranked live host observes
    its stale heartbeat, decides the round, and publishes the verdict —
    first write wins, the cluster keeps moving."""
    exs = [_mk_exchange(transport(), h, 3) for h in range(3)]
    res = {1: [], 2: []}

    def host0():
        exs[0].gather(b"a0")
        exs[0].pause_heartbeat()       # dies after round 0

    def survivor(h):
        def run():
            for r in range(3):
                res[h].append(exs[h].gather(b"p%d-%d" % (r, h)))
            exs[h].close()
        return run

    assert _run_hosts([host0, survivor(1), survivor(2)]) == [None] * 3
    for h in (1, 2):
        assert res[h][0].fold == [0, 1, 2]
        assert res[h][1].removed == [0]
        assert res[h][1].fold == [1, 2]
        assert res[h][2].members == [1, 2]
    assert exs[1].reconfigurations == exs[2].reconfigurations


def test_rejoin_handshake(transport):
    """A respawned host requests admission, the arbiter acks after the
    fold of its admission round with the state blob + stream position,
    and the joiner gathers from its first active round on."""
    ex0 = _mk_exchange(transport(), 0, 2)
    ex1 = _mk_exchange(transport(), 1, 2)
    new1 = ResilientExchange(transport(), host_id=1, num_hosts=2,
                             rejoin=True, heartbeat_timeout=1.0,
                             heartbeat_interval=0.1, poll_interval=0.02)
    res0, ack_box, resj = [], [], []
    ctl = SplitEEController(CostModel(num_layers=3, alpha=0.6, offload=2.0))
    blob = state_to_bytes(ctl.state)

    def host0():
        for r in range(6):
            res0.append(ex0.gather(b"a%d" % r))
            ex0.post_fold(blob, selected=(r + 1) * 8)
        ex0.close()

    def host1():
        ex1.gather(b"b0")
        ex1.pause_heartbeat()          # dies after round 0

    def joiner():
        time.sleep(0.5)
        ack = new1.request_rejoin(timeout_s=30.0)
        ack_box.append(ack)
        for r in range(ack.first_round, 6):
            resj.append(new1.gather(b"j%d" % r))
            new1.post_fold(blob, selected=(r + 1) * 8)
        new1.close()

    assert _run_hosts([host0, host1, joiner]) == [None] * 3
    ack = ack_box[0]
    jr = ack.first_round
    assert 1 <= jr <= 5
    assert ack.selected == jr * 8          # stream position at admission
    assert ack.members == [0, 1]
    np.testing.assert_array_equal(ack.state["q"], ctl.state.q)
    for r, resj_r in zip(range(jr, 6), resj):
        assert resj_r.fold == [0, 1]
        assert resj_r.payloads == res0[r].payloads
    removed = [c for c in ex0.reconfigurations if c["removed"] == [1]]
    joined = [c for c in ex0.reconfigurations if c["joined"] == [1]]
    assert removed and joined
    assert ex0.members == [0, 1]


@pytest.fixture()
def tcp_hosts():
    """(server, a factory of CoordinatorKV clients) for one test."""
    server = open_tcp_store("localhost", 0, is_master=True, timeout_s=30)
    return server, lambda: CoordinatorKV(open_tcp_store(
        "localhost", server.port, is_master=False, timeout_s=30))


def test_coordinator_exchange_gc_and_namespaces(tcp_hosts):
    """Two live lockstep exchanges per host (back-to-back serving passes)
    interleave rounds without key collisions; each round's gather
    deletes the host's previous-round key, and the barrier'd close the
    final round's."""
    _, client = tcp_hosts
    probe = client()

    def host(h):
        def run():
            kv = client()
            ex_a = tdist.CoordinatorExchange(kv=kv, host_id=h, num_hosts=2,
                                             epoch=0, timeout_ms=30_000)
            ex_b = tdist.CoordinatorExchange(kv=kv, host_id=h, num_hosts=2,
                                             epoch=1, timeout_ms=30_000)
            assert ex_a._prefix != ex_b._prefix
            for r in range(3):
                ga = ex_a.allgather_bytes(b"a%d-%d" % (r, h))
                gb = ex_b.allgather_bytes(b"b%d-%d" % (r, h))
                assert ga == [b"a%d-0" % r, b"a%d-1" % r], ga
                assert gb == [b"b%d-0" % r, b"b%d-1" % r], gb
                assert kv.try_get(f"{ex_a._prefix}/{r}/{h}") is not None
                if r > 0:
                    assert kv.try_get(f"{ex_a._prefix}/{r - 1}/{h}") is None
            ex_b.close()
            ex_a.close()
        return run

    assert _run_hosts([host(0), host(1)]) == [None, None]
    for prefix in ("splitee/xhost/0", "splitee/xhost/1"):
        for h in range(2):
            assert probe.try_get(f"{prefix}/2/{h}") is None


def test_coordinator_close_barrier_times_out_cleanly(tcp_hosts):
    """close() is barrier'd; with a participant missing it raises within
    the exchange timeout instead of wedging the survivor."""
    _, client = tcp_hosts
    exs = [tdist.CoordinatorExchange(kv=client(), host_id=h, num_hosts=2,
                                     epoch=0, timeout_ms=1500)
           for h in range(2)]
    errs = _run_hosts([lambda h=h: exs[h].allgather_bytes(b"x%d" % h)
                       for h in range(2)])
    assert errs == [None, None]
    t0 = time.monotonic()
    with pytest.raises(KVTimeout, match="1 of 2 arrived"):
        exs[0].close()                 # host 1 never calls close()
    assert 1.5 <= time.monotonic() - t0 < 10


def test_loopback_exchange():
    ex = tdist.LoopbackExchange()
    assert (ex.num_hosts, ex.host_id) == (1, 0)
    assert ex.allgather_bytes(b"p") == [b"p"]
    ex.close()


# ------------------------------------------------------------ served streams

def _smoke_cfgs():
    base = dict(num_layers=3, d_model=32, num_heads=2, num_kv_heads=2,
                d_ff=128, vocab_size=VOCAB, num_classes=2, dtype="float32")
    return (dataclasses.replace(get_smoke_config("elasticbert12"), **base),
            dataclasses.replace(t_get_smoke_config("elasticbert12"), **base))


def _data():
    return make_dataset("imdb_like", N_SAMPLES, seed=2, seq_len=16)


@pytest.fixture(scope="module")
def bed():
    """The reference's smoke testbed (3 layers, d 32, f32) on bridged
    weights, alpha in a gap of the exit confidences."""
    cfg, tcfg = _smoke_cfgs()
    jp = init_params(cfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    conf = np.sort(np.asarray(forward_exits(
        jp, cfg, {"tokens": _data()["tokens"]})["conf"]).ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    alpha = float(conf[k] + conf[k + 1]) / 2
    assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=params_from_jax(npp,
                                                              device="cpu"),
                alpha=alpha,
                jrt=JRuntime(cfg, backend="ref",
                             conf_backend="pallas_interpret"),
                jcost=JCostModel(num_layers=3, alpha=alpha, offload=3.0),
                tcost=CostModel(num_layers=3, alpha=alpha, offload=3.0))


def _tstream():
    return TStream(t_make_dataset("imdb_like", N_SAMPLES, seed=2, seq_len=16),
                   seed=0)


def _jstream():
    return OnlineStream(_data(), seed=0)


def _assert_bitwise(got, ref, skip=()):
    """Two reports of the port: every field but the wall-clock ones (and
    ``skip``) bit for bit."""
    for f in dataclasses.fields(got):
        if f.name in WALL_FIELDS + tuple(skip):
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "state":
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _assert_matches_reference(got, ref, skip=()):
    """Decisions exactly, confidence-derived floats within FLOAT_RTOL."""
    for key in ("arms", "exited", "preds"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["n"] == ref["n"] and got["offload_bytes"] == \
        ref["offload_bytes"]
    np.testing.assert_allclose(got["rewards"], ref["rewards"],
                               rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    np.testing.assert_allclose(got["state"]["q"], ref["state"]["q"],
                               rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    np.testing.assert_array_equal(got["state"]["n"], ref["state"]["n"])
    assert got["state"]["t"] == ref["state"]["t"]
    assert abs(got["cost_total"] - ref["cost_total"]) <= \
        FLOAT_ATOL + FLOAT_RTOL * abs(ref["cost_total"])
    for key in ("overlap", "distributed"):
        if key not in skip:
            assert got[key] == ref[key], key


CASES = {"sync": dict(overlap=False), "K=1": dict(overlap_depth=1),
         "K=2": dict(overlap_depth=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_host_matches_reference_and_sharded(bed, case):
    """One host (loopback exchange): the reference's own distributed run
    on the same weights, and the port's sharded R = 1 run bit for bit."""
    kw = dict(batch_size=BATCH, **CASES[case])
    got = serve(EdgeCloudRuntime(bed["tcfg"], device="cpu"), bed["tp"],
                _tstream(), bed["tcost"],
                ServingConfig(path="distributed", **kw))
    ref = jserve(bed["jrt"], bed["jp"], _jstream(), bed["jcost"],
                 JConfig(path="distributed", **kw))
    assert got.path == ref.path == "distributed"
    assert got.distributed == {"num_hosts": 1, "host_id": 0,
                               "local_replicas": 1}
    _assert_matches_reference(got, ref)
    sharded = serve(EdgeCloudRuntime(bed["tcfg"], device="cpu"), bed["tp"],
                    _tstream(), bed["tcost"],
                    ServingConfig(path="sharded", **kw))
    _assert_bitwise(got, sharded, skip=("path", "distributed"))


def test_one_host_fault_tolerant_is_the_sharded_run(bed, tmp_path):
    """The fault-tolerance machinery is policy-neutral: one host over a
    FileKV exchange (verdicts every round) is the sharded run bit for
    bit, with nothing lost and no reconfiguration."""
    ex = ResilientExchange(FileKV(str(tmp_path)), host_id=0, num_hosts=1,
                           heartbeat_timeout=2.0, poll_interval=0.01)
    kw = dict(batch_size=BATCH, overlap=False)
    got = serve(EdgeCloudRuntime(bed["tcfg"], device="cpu"), bed["tp"],
                _tstream(), bed["tcost"],
                ServingConfig(path="distributed", record_states=True, **kw),
                exchange=ex)
    sharded = serve(EdgeCloudRuntime(bed["tcfg"], device="cpu"), bed["tp"],
                    _tstream(), bed["tcost"],
                    ServingConfig(path="sharded", **kw))
    _assert_bitwise(got, sharded, skip=("path", "distributed", "states"))
    assert got.distributed["fault_tolerant"] is True
    assert got.distributed["lost_samples"] == 0
    assert got.distributed["reconfigurations"] == []
    assert len(got.states) == -(-N_SAMPLES // BATCH)
    np.testing.assert_array_equal(got.states[-1]["q"], got.state["q"])


def _thread_hosts(bed, hosts, transport, tmp_path, kw):
    """Serve the stream on ``hosts`` threads, each with its own runtime,
    stream and exchange; returns the reports in host order."""
    server = None
    if transport == "tcp":
        server = open_tcp_store("localhost", 0, is_master=True, timeout_s=30)
    exchanges = []
    for h in range(hosts):
        if transport == "tcp":
            kv = CoordinatorKV(open_tcp_store("localhost", server.port,
                                              is_master=False, timeout_s=30))
            exchanges.append(tdist.CoordinatorExchange(
                kv=kv, host_id=h, num_hosts=hosts, epoch=0,
                timeout_ms=30_000))
        else:
            exchanges.append(ResilientExchange(
                FileKV(str(tmp_path / "kv")), host_id=h, num_hosts=hosts,
                epoch=0, heartbeat_timeout=10.0, poll_interval=0.005))
    reports = [None] * hosts

    def host(h):
        def run():
            reports[h] = serve(
                EdgeCloudRuntime(bed["tcfg"], device="cpu"), bed["tp"],
                _tstream(), bed["tcost"],
                ServingConfig(path="distributed", **kw),
                exchange=exchanges[h])
        return run

    assert _run_hosts([host(h) for h in range(hosts)], timeout=120) == \
        [None] * hosts
    return reports


@pytest.mark.parametrize("transport", ["tcp", "file"])
@pytest.mark.parametrize("hosts", [2, 3])
@pytest.mark.parametrize("case", ["sync", "K=2"])
def test_hosts_as_threads_match_the_reference_one_process_run(
        bed, tmp_path, hosts, transport, case):
    """H hosts as threads, lockstep over a TCPStore or fault-tolerant
    over FileKV. Against the reference's single-process sharded run:
    decisions exactly, floats within rtol = atol = 1e-6 (never bitwise
    across frameworks). Against the port's own single-process sharded
    run, every mirror bit for bit: on the CPU at one intra-op thread a
    slice's rows come out with the same bits as in the whole batch."""
    kw = dict(batch_size=BATCH, **CASES[case])
    reps = _thread_hosts(bed, hosts, transport, tmp_path, kw)
    own = serve(EdgeCloudRuntime(bed["tcfg"], device="cpu"), bed["tp"],
                _tstream(), bed["tcost"], ServingConfig(path="sharded", **kw))
    ref = jserve(bed["jrt"], bed["jp"], _jstream(), bed["jcost"],
                 JConfig(path="sharded", **kw))
    for h, rep in enumerate(reps):
        assert rep.distributed["num_hosts"] == hosts
        assert rep.distributed["host_id"] == h
        _assert_matches_reference(rep, ref, skip=("distributed",))
        _assert_bitwise(rep, own, skip=("path", "distributed"))
    if transport == "file":
        assert reps[0].distributed["lost_samples"] == 0
        assert reps[0].distributed["members_final"] == list(range(hosts))


# --------------------------------------------------------- subprocess clusters
# CPU workers, one intra-op thread each, on the port's own seeded weights;
# each cluster has its own timeout. Detection bounds leave room for the
# suite's parallel workers: 2 x heartbeat_timeout + 2 s.

_WORKER = """
import base64, dataclasses, itertools, json, os, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.serving import init_distributed_from_env, ft_serving_context
FT = os.environ.get("TEST_FT") == "1"
HB = float(os.environ.get("TEST_HB_TIMEOUT", "3.0"))
if FT:
    exchange, init_state, skip = ft_serving_context(heartbeat_timeout=HB)
else:
    init_distributed_from_env()
    exchange, init_state, skip = None, None, 0
from repro_torch.configs import get_smoke_config
from repro_torch.core import CostModel
from repro_torch.core.controller import state_from_bytes, state_to_bytes
from repro_torch.data import OnlineStream, make_dataset
from repro_torch.data.synthetic import VOCAB
from repro_torch.models.transformer import init_params
from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve

sb64 = os.environ.get("TEST_INIT_STATE_B64")
if sb64:
    init_state = state_from_bytes(base64.b64decode(sb64))
    skip = int(os.environ["TEST_SKIP"])
cfg = dataclasses.replace(
    get_smoke_config("elasticbert12"), num_layers=3, d_model=32,
    num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=VOCAB, num_classes=2,
    dtype="float32")
params = init_params(cfg, seed=0, device="cpu")
data = make_dataset("imdb_like", 256, seed=2, seq_len=16)
cost = CostModel(num_layers=3, alpha=float(os.environ["TEST_ALPHA"]),
                 offload=3.0)
for kw in json.loads(os.environ["TEST_RUNS"]):
    stream = iter(OnlineStream(data, seed=0))
    if skip:
        stream = itertools.islice(stream, skip, None)
    config = ServingConfig(path="distributed", record_states=True,
                           max_samples=int(os.environ["TEST_MAX_SAMPLES"])
                           - skip, **kw)
    out = serve(EdgeCloudRuntime(cfg, device="cpu"), params, stream, cost,
                config, exchange=exchange, init_state=init_state,
                stream_offset=skip)
    d = out["distributed"]
    print("RESULT " + json.dumps({
        "run": kw, "host": d["host_id"], "num_hosts": d["num_hosts"],
        "n": out["n"], "skip": skip, "preds": out["preds"].tolist(),
        "arms": out["arms"].tolist(), "rewards": out["rewards"].tolist(),
        "exited": out["exited"].tolist(), "q": out["state"]["q"].tolist(),
        "n_state": out["state"]["n"].tolist(), "t": out["state"]["t"],
        "lost": d.get("lost_samples"), "reconf": d.get("reconfigurations"),
        "members_final": d.get("members_final"),
        "states": [base64.b64encode(state_to_bytes(s)).decode()
                   for s in out["states"]]}), flush=True)
"""

CLUSTER_ALPHA = 0.6


def _cluster_env(**extra):
    env = {"PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "TEST_ALPHA": str(CLUSTER_ALPHA)}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _results(completed, skip_slots=()):
    res = {}
    for i, p in enumerate(completed):
        if i in skip_slots:
            continue
        assert p.returncode == 0, (i, p.returncode, p.stderr[-4000:])
        lines = [json.loads(ln[len("RESULT "):])
                 for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        assert lines, (i, p.stdout[-2000:])
        res[i] = lines
    return res


def _unsnap(b64):
    z = np.load(io.BytesIO(base64.b64decode(b64)))
    return z["q"], z["n"], int(z["t"])


@pytest.fixture(scope="module")
def cluster_ref():
    """The port's single-process sharded runs of the workers' stream (the
    port's seeded weights), alpha in a gap of its exit confidences."""
    from repro_torch.models.transformer import forward_exits as t_exits
    from repro_torch.models.transformer import init_params as t_init
    _, tcfg = _smoke_cfgs()
    params = t_init(tcfg, seed=0, device="cpu")
    data = t_make_dataset("imdb_like", 256, seed=2, seq_len=16)
    conf = np.sort(t_exits(params, tcfg, {"tokens": torch.as_tensor(
        data["tokens"][:N_SAMPLES])})["conf"].numpy().ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    alpha = float(conf[k] + conf[k + 1]) / 2
    assert np.abs(conf - alpha).min() >= ALPHA_MARGIN
    cost = CostModel(num_layers=3, alpha=alpha, offload=3.0)
    runs = {name: serve(EdgeCloudRuntime(tcfg, device="cpu"), params,
                        TStream(data, seed=0), cost,
                        ServingConfig(path="sharded", batch_size=BATCH,
                                      max_samples=N_SAMPLES, **kw))
            for name, kw in (("sync", CASES["sync"]), ("K=2", CASES["K=2"]))}
    return alpha, runs


def test_two_process_lockstep_over_tcp_store(cluster_ref):
    """Two CPU worker processes, lockstep over the TCPStore process 0
    serves, at overlap off and K = 2: both mirrors, and the port's
    single-process sharded run, equal bit for bit (CPU, one intra-op
    thread a worker)."""
    runs = [dict(batch_size=BATCH, **CASES["sync"]),
            dict(batch_size=BATCH, **CASES["K=2"])]
    alpha, refs = cluster_ref
    rep = run_supervised_cluster(
        _WORKER, 2, env=_cluster_env(TEST_RUNS=json.dumps(runs),
                                     TEST_MAX_SAMPLES=N_SAMPLES,
                                     TEST_ALPHA=repr(alpha)),
        cwd=ROOT, timeout=150)
    res = _results(rep.completed)
    assert rep.incidents == []
    for i, name in enumerate(("sync", "K=2")):
        a, b = res[0][i], res[1][i]
        assert (a["host"], b["host"], a["num_hosts"]) == (0, 1, 2)
        for key in ("arms", "preds", "rewards", "exited", "q", "n_state",
                    "t", "states"):
            assert a[key] == b[key], key
        ref = refs[name]
        for key in ("arms", "preds", "exited", "rewards"):
            assert a[key] == ref[key].tolist(), key
        assert a["q"] == ref.state["q"].tolist()
        assert a["n_state"] == ref.state["n"].tolist()
        assert a["t"] == ref.state["t"]


def test_killed_worker_invariant_3_to_2(tmp_path):
    """THE acceptance invariant. Run A: 3 hosts over FileKV, host 1
    killed at epoch 3 — completes, detection within the bound, exactly
    host 1's slice of epoch 3 lost. Run B: 2 hosts seeded with run A's
    merged state at epoch 3, serving the rest of the stream. From epoch 4
    on, run A's survivors evolve bit for bit as run B."""
    hb = 2.0
    runs = json.dumps([dict(batch_size=12, overlap=False)])
    env_a = _cluster_env(SPLITEE_KV_DIR=tmp_path / "kv-a", TEST_FT=1,
                         SPLITEE_FAULTS="kill:host=1,epoch=3",
                         TEST_HB_TIMEOUT=hb, TEST_RUNS=runs,
                         TEST_MAX_SAMPLES=96)
    t0 = time.monotonic()
    rep = run_supervised_cluster(_WORKER, 3, env=env_a, cwd=ROOT,
                                 coordinator=False, fail_fast=False,
                                 timeout=150)
    wall = time.monotonic() - t0
    assert rep.completed[1].returncode == FAULT_KILL_EXIT
    res = _results(rep.completed, skip_slots={1})
    a0, a2 = res[0][0], res[2][0]
    assert wall < 120, wall
    assert len(a0["reconf"]) == 1
    assert a0["reconf"][0]["round"] == 3
    assert a0["reconf"][0]["removed"] == [1]
    # bound: 2 x heartbeat timeout + 2 s
    assert a0["reconf"][0]["detect_s"] < 2 * hb + 2.0
    for key in ("q", "n_state", "t", "preds", "states"):
        assert a0[key] == a2[key], key
    assert a0["lost"] == 4                           # 12 over 3 hosts
    assert a0["members_final"] == [0, 2]
    assert a0["preds"][40:44] == [-1] * 4            # host 1's rows of e=3
    assert -1 not in a0["preds"][:40] + a0["preds"][44:]

    env_b = _cluster_env(SPLITEE_KV_DIR=tmp_path / "kv-b", TEST_FT=1,
                         TEST_INIT_STATE_B64=a0["states"][3], TEST_SKIP=48,
                         TEST_HB_TIMEOUT=hb, TEST_RUNS=runs,
                         TEST_MAX_SAMPLES=96)
    rep_b = run_supervised_cluster(_WORKER, 2, env=env_b, cwd=ROOT,
                                   coordinator=False, timeout=150)
    b0 = _results(rep_b.completed)[0][0]
    for r in range(4):
        qa, na, ta = _unsnap(a0["states"][4 + r])
        qb, nb, tb = _unsnap(b0["states"][r])
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(na, nb)
        assert ta == tb
    assert a0["preds"][48:] == b0["preds"]
    for key in ("arms", "rewards", "exited"):
        assert a0[key][-48:] == b0[key], key
    for key in ("q", "n_state", "t"):
        assert a0[key] == b0[key], key


def test_respawned_worker_rejoins(tmp_path):
    """Supervisor mode end to end: the killed worker is respawned with
    the rejoin flag, downloads the merged state + stream position from
    the KV store, re-enters at an epoch boundary, and finishes with a
    controller mirror bit-identical to the survivors'."""
    runs = json.dumps([dict(batch_size=12, overlap=False)])
    env = _cluster_env(
        SPLITEE_KV_DIR=tmp_path / "kv", TEST_FT=1, TEST_RUNS=runs,
        SPLITEE_FAULTS="kill:host=1,epoch=3;sleep:host=*,epoch=*,secs=0.8",
        TEST_MAX_SAMPLES=144)
    rep = run_supervised_cluster(_WORKER, 3, env=env, cwd=ROOT,
                                 coordinator=False, fail_fast=False,
                                 respawn=True, max_respawns=1, timeout=150)
    assert rep.respawns[1] == 1
    kinds = [(i.kind, i.slot) for i in rep.incidents]
    assert ("exit", 1) in kinds and ("respawn", 1) in kinds
    res = _results(rep.completed)
    a0, a1, a2 = res[0][0], res[1][0], res[2][0]
    for key in ("q", "n_state", "t"):
        assert a0[key] == a1[key] == a2[key], key
    assert a1["skip"] > 0 and a1["n"] > 0
    assert a1["skip"] + a1["n"] == 144
    assert a0["preds"][a1["skip"]:] == a1["preds"]
    # the joiner's mirror equals the survivors' from its first round on
    first = a1["skip"] // 12
    assert a0["states"][first:] == a1["states"]
    assert any(c["removed"] == [1] for c in a0["reconf"])
    assert any(c["joined"] == [1] for c in a0["reconf"])
    assert a0["members_final"] == [0, 1, 2]
    assert a0["lost"] == 4
    assert not glob.glob(str(tmp_path / "kv" / "splitee" / "ft" / "*" /
                             "round" / "*" / "*"))


# ------------------------------------------------------ supervisor pieces

def test_worker_watchdog_staleness(tmp_path):
    """The supervisor's hung-worker test (`_Worker.hb_stale`): a worker
    not stamping yet is stale only past its start-up grace, one whose
    liveness file stopped advancing only past the watchdog timeout."""
    proc = subprocess.Popen([sys.executable, "-c", "import time; "
                             "time.sleep(60)"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    hb = tmp_path / "hb-0"
    try:
        w = tdist._Worker(0, proc, str(hb))
        assert not w.hb_stale(watchdog_timeout=1.0, startup_grace=30.0)
        assert w.hb_stale(watchdog_timeout=1.0, startup_grace=0.0)
        hb.write_text("1")
        assert not w.hb_stale(watchdog_timeout=1.0, startup_grace=0.0)
        old = time.time() - 5.0
        w.spawned_wall = old
        os.utime(hb, (old, old))
        assert w.hb_stale(watchdog_timeout=1.0, startup_grace=0.0)
        assert not w.hb_stale(watchdog_timeout=10.0, startup_grace=0.0)
    finally:
        proc.kill()
        w.thread.join(30)
    assert not w.thread.is_alive() and w.out[0] == -signal.SIGKILL


def test_respawn_distributed_relays_argv(monkeypatch, capsys):
    """`respawn_distributed` re-runs ``sys.argv`` in every worker, and
    `drive_respawned_cluster` echoes host 0, aborts a lockstep cluster
    on any failed worker and lets a fault-tolerant one report it."""
    seen = {}

    def fake(worker_src, n, **kw):
        seen.update(src=worker_src, n=n, kw=kw)
        procs = [subprocess.CompletedProcess("w", rc, f"out{i}\n", f"err{i}")
                 for i, rc in enumerate(seen["rcs"])]
        return tdist.ClusterReport(completed=procs, incidents=[],
                                   respawns={})

    monkeypatch.setattr(tdist, "run_supervised_cluster", fake)
    monkeypatch.setattr(sys, "argv", ["/x/serve.py", "--samples", "8"])
    seen["rcs"] = [0, 0]
    tdist.drive_respawned_cluster(2, coordinator=False)
    assert seen["n"] == 2 and seen["kw"]["coordinator"] is False
    assert seen["kw"]["timeout"] is None
    assert "['/x/serve.py', '--samples', '8']" in seen["src"]
    assert "runpy.run_path('/x/serve.py', run_name='__main__')" in seen["src"]
    assert capsys.readouterr().out == "out0\n"
    seen["rcs"] = [0, 3]
    with pytest.raises(SystemExit, match="worker 1 exited 3"):
        tdist.drive_respawned_cluster(2)
    tdist.drive_respawned_cluster(2, fail_fast=False)
    captured = capsys.readouterr()
    assert captured.out == "out0\n"
    assert "worker 1 exited 3 (cluster continued without it)" in captured.err


def test_a_host_starting_after_one_heartbeat_timeout_is_not_fenced(tmp_path):
    """The cause of round-0 fencing under load: a host whose heartbeat
    has not started yet (still importing and building on a loaded
    machine) shows no stamp at all. It is waited for up to
    STARTUP_TIMEOUT, not declared dead after one heartbeat timeout:
    here it starts 4 timeouts late and both hosts fold round 0."""
    kv = str(tmp_path / "kv")
    hb = 0.25
    ex0 = _mk_exchange(FileKV(kv), 0, 2, heartbeat_timeout=hb)
    got = {}

    def late_host():
        time.sleep(4 * hb)
        ex1 = _mk_exchange(FileKV(kv), 1, 2, heartbeat_timeout=hb)
        got[1] = ex1.gather(b"p1")
        ex1.close()

    t = threading.Thread(target=late_host)
    t.start()
    got[0] = ex0.gather(b"p0")
    t.join(timeout=30)
    ex0.close()
    for h in (0, 1):
        assert got[h].removed == [] and got[h].fold == [0, 1], h
        assert got[h].payloads == [b"p0", b"p1"], h


def test_a_host_that_never_starts_is_declared_dead_within_startup_timeout(
        tmp_path, monkeypatch):
    """A host that dies before its first heartbeat stamp is still
    detected: removed in round 0 within STARTUP_TIMEOUT plus a poll of
    the round's first look at it (the bound the monitor states)."""
    startup = 1.0
    monkeypatch.setattr(tdist, "STARTUP_TIMEOUT", startup)
    ex0 = _mk_exchange(FileKV(str(tmp_path / "kv")), 0, 2,
                       heartbeat_timeout=0.25)
    t0 = time.monotonic()
    res = ex0.gather(b"p0")
    wall = time.monotonic() - t0
    ex0.close()
    assert res.removed == [1] and res.fold == [0] and res.members == [0]
    # detect_s is rounded to 3 decimals (the verdict of `_decide` in
    # serving/distributed.py), so a detection within 0.5 ms after the
    # timeout reads as the timeout itself: compare at that resolution
    assert startup <= ex0.reconfigurations[0]["detect_s"] < startup + 0.5
    assert wall < startup + 1.0
