"""Pluggable key-value transports for the cross-host serving exchange.

The distributed serving runtime (serving/distributed.py) uses NO device
collective: the only cross-process coupling is a key-value store carrying
O(B*L) bandit summaries per batch. That makes the transport pluggable,
and this module provides the two backends the exchanges run over:

* `CoordinatorKV` — a ``torch.distributed.TCPStore`` (its server lives in
  process 0 of the cluster, as the reference's jax.distributed
  coordinator does; nothing else is deployed, and no process group is
  initialized);
* `FileKV` — a directory on a shared filesystem, with atomic writes.
  Process clusters on one machine can serve with no store server at all,
  which is what makes worker death, respawn and rejoin testable: there
  is no server process whose death takes the transport along, only keys.
  Its on-disk layout is the reference's, so a directory written by one
  package reads in the other.

Both expose the same primitives:

  set(key, value, overwrite=False)   first-writer-wins unless overwrite
  try_get(key) -> Optional[bytes]    non-blocking probe
  get(key, timeout_s) -> bytes       blocking read, KVTimeout on expiry
  delete(key)                        idempotent

First-writer-wins `set` is the concurrency primitive the exchange's
arbiter failover relies on (two would-be arbiters race to publish a
round verdict; exactly one wins and both fold the winner's).
"""
from __future__ import annotations

import datetime
import os
import tempfile
import threading
import time
from typing import List, Optional


class KVTimeout(TimeoutError):
    """A blocking `get` expired before the key appeared."""


class KVKeyExists(RuntimeError):
    """`set(..., overwrite=False)` lost a first-writer-wins race."""


class FileKV:
    """KV store over a directory: one file per key, atomic publication.

    Writes go to a temp file first; publication is `os.link` (exclusive
    — fails if the key exists, giving first-writer-wins) or `os.replace`
    (overwrite). Readers therefore never observe partial values. Works
    across processes sharing a filesystem; polling-based blocking reads.
    """

    def __init__(self, root: str, *, poll_interval: float = 0.02):
        self.root = os.path.abspath(root)
        self.poll_interval = poll_interval
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        return os.path.join(self.root, *parts)

    def set(self, key: str, value: bytes, *, overwrite: bool = False):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".kv-", dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(value)
            if overwrite:
                os.replace(tmp, path)
                tmp = None
            else:
                try:
                    os.link(tmp, path)
                except FileExistsError:
                    raise KVKeyExists(key) from None
        finally:
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None

    def get(self, key: str, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            value = self.try_get(key)
            if value is not None:
                return value
            if time.monotonic() > deadline:
                raise KVTimeout(f"key {key!r} absent after {timeout_s}s")
            time.sleep(self.poll_interval)

    def delete(self, key: str):
        try:
            os.unlink(self._path(key))
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            pass

    def list_keys(self, prefix: str) -> List[str]:
        path = self._path(prefix)
        try:
            names = os.listdir(path)
        except (FileNotFoundError, NotADirectoryError):
            return []
        return sorted(f"{prefix.rstrip('/')}/{n}" for n in names
                      if not n.startswith(".kv-"))


class CoordinatorKV:
    """KV store over a ``torch.distributed.TCPStore``.

    Values are raw bytes: the reference base64-encodes them to get round
    a jax 0.4.37 bug in the coordinator's bytes API, which a TCPStore
    does not have.

    Every primitive is one non-blocking request to the store's server,
    made under a lock, so one object serves the serving thread and the
    heartbeat thread together: a server-side blocking wait would hold the
    connection and stall the other thread's stamps. So:

    * ``try_get`` is ``compare_set(key, probe, probe)`` with a private
      probe value: the store answers with the key's value, or with the
      probe when the key is absent, and writes nothing either way. A
      ``check`` followed by a ``get`` would race with a concurrent
      ``delete`` (the get would then block for the store's timeout);
    * ``get`` polls ``try_get`` until the key appears or ``timeout_s``
      passes (`KVTimeout`);
    * an overwriting ``set`` is a ``set``, which gets no reply, followed
      by a ``check`` of the key on the same connection, which does: the
      server answers a connection's requests in order, so the call
      returns once the server holds the value and another handle's later
      read sees it (the reference's ``key_value_set`` is acknowledged
      too). It costs one round trip per overwrite;
    * an exclusive ``set`` is ``compare_set(key, "", value)``: the store
      writes only when the key is absent and answers with the value the
      key then holds, so a second writer gets the first writer's value
      back and raises `KVKeyExists`. A second writer of byte-identical
      bytes cannot be told from the first; in the exchange only verdicts
      race, and two identical verdicts fold identically. An empty value
      would read as "absent" to ``compare_set`` and is refused.
    """

    def __init__(self, store=None, *, poll_interval: float = 0.01):
        if store is None:
            from repro_torch.serving.distributed import _cluster_store
            store = _cluster_store()
        if store is None:
            raise RuntimeError(
                "no cluster store is open — call init_distributed_from_env() "
                "first (CoordinatorKV needs the TCPStore it opens), pass a "
                "TCPStore, or use FileKV for coordinator-free clusters")
        self._store = store
        self.poll_interval = poll_interval
        self._lock = threading.Lock()
        # a value no caller stores: 16 random bytes
        self._probe = b"\x00probe:" + os.urandom(16)

    def set(self, key: str, value: bytes, *, overwrite: bool = False):
        with self._lock:
            if overwrite:
                self._store.set(key, value)
                self._store.check([key])
                return
            if not value:
                raise ValueError(f"exclusive set of {key!r} needs a "
                                 f"non-empty value")
            held = self._store.compare_set(key, "", value)
        if held != value:
            raise KVKeyExists(key)

    def try_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            value = self._store.compare_set(key, self._probe, self._probe)
        return None if value == self._probe else value

    def get(self, key: str, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            value = self.try_get(key)
            if value is not None:
                return value
            if time.monotonic() > deadline:
                raise KVTimeout(f"key {key!r} absent after {timeout_s}s")
            time.sleep(self.poll_interval)

    def delete(self, key: str):
        with self._lock:
            self._store.delete_key(key)

    def barrier(self, name: str, count: int, timeout_s: float):
        """Block until ``count`` callers have entered barrier ``name``
        (`KVTimeout` after ``timeout_s``). A name serves one barrier."""
        with self._lock:
            self._store.add(name, 1)
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                arrived = self._store.add(name, 0)
            if arrived >= count:
                return
            if time.monotonic() > deadline:
                raise KVTimeout(f"barrier {name!r}: {arrived} of {count} "
                                f"arrived after {timeout_s}s")
            time.sleep(self.poll_interval)


def open_tcp_store(host: str, port: int, *, is_master: bool,
                   timeout_s: float = 300.0):
    """A ``TCPStore`` client (``is_master``: also its server) at
    ``host:port``; a client waits up to ``timeout_s`` for the server."""
    from torch.distributed import TCPStore
    return TCPStore(host, port, is_master=is_master,
                    timeout=datetime.timedelta(seconds=timeout_s),
                    wait_for_workers=False)
