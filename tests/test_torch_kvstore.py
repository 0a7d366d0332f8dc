"""The port's KV transports (serving/kvstore.py) against the reference's.

* the four primitives (exclusive and overwriting ``set``, ``try_get``,
  ``get`` with its timeout, idempotent ``delete``) over both transports:
  `FileKV` on a directory and `CoordinatorKV` over a
  ``torch.distributed.TCPStore`` whose server runs in this process;
* two writers racing an exclusive ``set`` of one key: exactly one wins
  and every reader sees the winner's bytes;
* one `CoordinatorKV` shared by a polling reader and a stamping thread
  (the exchange's heartbeat) while a third thread deletes;
* a directory written by the port's `FileKV` reads in the reference's,
  and the other way round (the on-disk layout is the reference's);
* `CoordinatorKV` without a store raises, and refuses an exclusive empty
  value (``compare_set`` reads "" as absent);
* an overwriting ``set`` through a connection whose bytes reach the
  server late is held by the server when it returns: another handle
  reads the new value at once (a bare ``TCPStore.set`` gets no reply).
"""
import queue
import socket
import sys
import threading
import time

import pytest
import torch

from repro.serving.kvstore import FileKV as JFileKV
from repro.serving.kvstore import KVKeyExists as JKVKeyExists
from repro_torch.serving.kvstore import (CoordinatorKV, FileKV, KVKeyExists,
                                         KVTimeout, open_tcp_store)

BLOB = bytes(range(256)) * 3 + b"\x00"          # every byte value, a NUL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread under the suite's parallel workers (see
    tests/test_torch_sharded.py); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tcp_server():
    """A TCPStore whose server lives in this process for the module."""
    store = open_tcp_store("localhost", 0, is_master=True, timeout_s=30)
    yield store


def _client(server):
    return open_tcp_store("localhost", server.port, is_master=False,
                          timeout_s=30)


@pytest.fixture(params=["file", "tcp"])
def make_kv(request, tmp_path, tcp_server):
    """A factory of KV handles on one shared namespace (one directory, or
    one TCPStore server with a client per handle); keys are prefixed per
    test so the module's shared server starts each test empty."""
    prefix = f"{request.node.name}/"
    if request.param == "file":
        return lambda: FileKV(str(tmp_path / "kv"), poll_interval=0.005), \
            prefix
    return lambda: CoordinatorKV(_client(tcp_server), poll_interval=0.005), \
        prefix


def test_set_get_delete_roundtrip(make_kv):
    mk, p = make_kv
    kv, other = mk(), mk()
    assert kv.try_get(p + "a/b") is None
    kv.set(p + "a/b", BLOB)
    assert other.try_get(p + "a/b") == BLOB
    assert other.get(p + "a/b", 1.0) == BLOB
    with pytest.raises(KVKeyExists):
        other.set(p + "a/b", b"second")
    assert kv.try_get(p + "a/b") == BLOB
    other.set(p + "a/b", b"over", overwrite=True)
    assert kv.try_get(p + "a/b") == b"over"
    kv.delete(p + "a/b")
    kv.delete(p + "a/b")                              # idempotent
    assert other.try_get(p + "a/b") is None
    kv.set(p + "a/b", b"again")                       # free after delete
    assert other.try_get(p + "a/b") == b"again"


def test_get_times_out_then_sees_a_late_write(make_kv):
    mk, p = make_kv
    kv, writer = mk(), mk()
    t0 = time.monotonic()
    with pytest.raises(KVTimeout, match="absent after"):
        kv.get(p + "missing", 0.3)
    waited = time.monotonic() - t0
    assert 0.3 <= waited < 3.0, waited
    timer = threading.Timer(0.2, lambda: writer.set(p + "late", b"x"))
    timer.start()
    try:
        assert kv.get(p + "late", 10.0) == b"x"
    finally:
        timer.join(5)
    assert not timer.is_alive()


def test_two_racing_exclusive_writers(make_kv):
    """Per key, two threads race an exclusive set with distinct values:
    exactly one set returns, the other raises KVKeyExists, and the key
    holds the winner's value."""
    mk, p = make_kv
    kvs = [mk(), mk()]
    keys = [f"{p}verdict/{i}" for i in range(40)]
    won = {0: [], 1: []}
    barrier = threading.Barrier(2)
    errors = []

    def writer(w):
        try:
            for key in keys:
                barrier.wait(10)
                try:
                    kvs[w].set(key, f"writer-{w}".encode())
                    won[w].append(key)
                except KVKeyExists:
                    pass
        except BaseException as e:     # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "writer wedged"
    assert errors == []
    assert sorted(won[0] + won[1]) == sorted(keys)   # one winner a key
    reader = mk()
    for w in (0, 1):
        for key in won[w]:
            assert reader.try_get(key) == f"writer-{w}".encode()


def test_shared_handle_under_concurrent_stamps_and_deletes(tcp_server):
    """One CoordinatorKV used by a polling reader, a stamping thread (the
    exchange's heartbeat) and a deleting thread at once: no operation
    blocks on another, and a read of a key deleted under it is None,
    never a wait for the store's timeout."""
    kv = CoordinatorKV(_client(tcp_server), poll_interval=0.001)
    stop = threading.Event()
    errors = []

    def stamp():
        i = 0
        while not stop.is_set():
            i += 1
            kv.set("shared/hb", str(i).encode(), overwrite=True)

    def churn():
        while not stop.is_set():
            kv.set("shared/churn", b"v", overwrite=True)
            kv.delete("shared/churn")

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
        return run

    threads = [threading.Thread(target=guard(f), daemon=True)
               for f in (stamp, churn)]
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        t0 = time.monotonic()
        seen = set()
        while time.monotonic() - t0 < 1.0:
            seen.add(kv.try_get("shared/churn"))
            stamp_now = kv.try_get("shared/hb")
            assert stamp_now is None or int(stamp_now) > 0
    finally:
        stop.set()
        sys.setswitchinterval(old_switch)
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert seen <= {None, b"v"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_kv_directories_read_across_packages(tmp_path, writer):
    """A directory one package's FileKV wrote reads in the other's: the
    same values, the same key listing, first-writer-wins across them."""
    ours, theirs = FileKV(str(tmp_path)), JFileKV(str(tmp_path))
    w, r = (ours, theirs) if writer == "port" else (theirs, ours)
    w.set("splitee/ft/0/round/3/1", BLOB)
    w.set("splitee/ft/0/round/3/0", b"p0")
    w.set("splitee/ft/0/hb/1", b"7", overwrite=True)
    assert r.try_get("splitee/ft/0/round/3/1") == BLOB
    assert r.get("splitee/ft/0/round/3/0", 1.0) == b"p0"
    assert r.list_keys("splitee/ft/0/round/3") == \
        w.list_keys("splitee/ft/0/round/3") == \
        ["splitee/ft/0/round/3/0", "splitee/ft/0/round/3/1"]
    with pytest.raises((KVKeyExists, JKVKeyExists)):
        r.set("splitee/ft/0/round/3/1", b"late")
    r.delete("splitee/ft/0/round/3/1")
    assert w.try_get("splitee/ft/0/round/3/1") is None


def test_coordinator_kv_needs_a_store_and_a_value():
    with pytest.raises(RuntimeError, match="init_distributed_from_env"):
        CoordinatorKV()


def test_coordinator_kv_refuses_an_empty_exclusive_value(tcp_server):
    kv = CoordinatorKV(_client(tcp_server))
    with pytest.raises(ValueError, match="non-empty"):
        kv.set("empty/x", b"")
    kv.set("empty/x", b"", overwrite=True)           # overwrite may
    assert kv.try_get("empty/x") == b""


def test_coordinator_kv_barrier(tcp_server):
    """`barrier` returns once ``count`` callers entered, and times out
    with the arrival count otherwise."""
    kvs = [CoordinatorKV(_client(tcp_server), poll_interval=0.005)
           for _ in range(3)]
    done = []

    def enter(kv):
        kv.barrier("barrier/a", 3, 10.0)
        done.append(time.monotonic())

    threads = [threading.Thread(target=enter, args=(kv,), daemon=True)
               for kv in kvs[:2]]
    for t in threads:
        t.start()
    time.sleep(0.3)
    assert done == []                                 # 2 of 3 arrived
    enter(kvs[2])
    for t in threads:
        t.join(10)
    assert len(done) == 3
    with pytest.raises(KVTimeout, match="1 of 2 arrived"):
        kvs[0].barrier("barrier/b", 2, 0.2)


class _DelayingProxy:
    """A TCP proxy on localhost in front of ``port`` that holds each chunk
    a client sends for ``delay`` seconds before passing it on, in order;
    the server's replies pass at once."""

    def __init__(self, port: int, delay: float):
        self.port_to, self.delay = port, delay
        self.listener = socket.create_server(("localhost", 0))
        self.port = self.listener.getsockname()[1]
        self.sockets = [self.listener]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                client, _ = self.listener.accept()
            except OSError:
                return
            server = socket.create_connection(("localhost", self.port_to))
            self.sockets += [client, server]
            self._pump(client, server, self.delay)
            self._pump(server, client, 0.0)

    @staticmethod
    def _pump(src, dst, delay):
        chunks = queue.Queue()

        def read():
            while True:
                try:
                    data = src.recv(65536)
                except OSError:
                    data = b""
                chunks.put((time.monotonic() + delay, data))
                if not data:
                    return

        def write():
            while True:
                due, data = chunks.get()
                time.sleep(max(0.0, due - time.monotonic()))
                try:
                    if not data:
                        dst.shutdown(socket.SHUT_WR)
                        return
                    dst.sendall(data)
                except OSError:
                    return
        for fn in (read, write):
            threading.Thread(target=fn, daemon=True).start()

    def close(self):
        for s in self.sockets:
            s.close()


def test_coordinator_overwrite_is_held_when_set_returns(tcp_server):
    """A client whose bytes reach the server 0.3 s late: its overwriting
    ``set`` returns only once the server holds the value, so a direct
    handle's ``try_get`` right after it reads the new value (it read the
    old one while ``set`` was a bare ``TCPStore.set``)."""
    delay = 0.3
    proxy = _DelayingProxy(tcp_server.port, delay)
    try:
        slow = CoordinatorKV(open_tcp_store("localhost", proxy.port,
                                            is_master=False, timeout_s=30))
        direct = CoordinatorKV(_client(tcp_server))
        for i in range(2):
            direct.set("acked/hb", f"old-{i}".encode(), overwrite=True)
            t0 = time.monotonic()
            slow.set("acked/hb", f"new-{i}".encode(), overwrite=True)
            assert direct.try_get("acked/hb") == f"new-{i}".encode()
            assert time.monotonic() - t0 >= delay
    finally:
        proxy.close()
