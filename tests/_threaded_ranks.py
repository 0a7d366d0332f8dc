"""Ranks as threads of this process over torch's threaded process group
(``torch.testing._internal.distributed.multi_threaded_pg``: its
collectives are tensor ops of this process), for CPU tests of ``DTensor``
code on a small mesh without starting processes."""
import threading

import torch
import torch.distributed as dist


def run_ranks(fn, world: int):
    """``fn(rank)`` on ``world`` threads, each rank of a threaded default
    process group of that size; returns {rank: result} and re-raises the
    first rank's error."""
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)
    results = {}

    def worker(rank, store):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results[rank] = e

    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    try:
        store = dist.HashStore()
        threads = [threading.Thread(target=worker, args=(r, store))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    for r in range(world):
        if isinstance(results.get(r), BaseException):
            raise results[r]
    return results
