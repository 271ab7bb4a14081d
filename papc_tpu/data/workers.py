"""Multiprocess sample preparation (spawn-based).

Design constraints this solves (found in review):
  * ``spawn`` start method — never forks a process that has initialized
    the JAX runtime (fork after backend init can deadlock);
  * workers run with ``JAX_PLATFORMS=cpu``, so they never open the GPU:
    one process per card;
  * the dataset is shipped to each worker ONCE via the pool initializer
    (a global in the worker), not pickled per task;
  * tasks are plain ``(epoch, idx)`` tuples; each call reseeds the
    dataset's stochastic components per (base_seed, epoch, idx) so
    results are deterministic for any worker count.
"""

from __future__ import annotations

import multiprocessing as mp
import os

_WORKER_DATASET = None


def _cpu_only_env():
    """Point child processes at the CPU; returns the previous value.

    Stays in effect for the POOL'S LIFETIME (not just construction):
    mp.Pool respawns crashed workers later, and a respawn under the
    original env would open the GPU at its first JAX call."""
    prev = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    return prev


def _restore_env(prev):
    if prev is None:
        os.environ.pop("JAX_PLATFORMS", None)
    else:
        os.environ["JAX_PLATFORMS"] = prev


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _fetch(task):
    epoch, idx = task
    ds = _WORKER_DATASET
    ds.set_epoch(epoch)
    return ds[idx]


class SamplePool:
    """Process pool mapping dataset indices → prepared samples."""

    def __init__(self, dataset, num_workers: int):
        ctx = mp.get_context("spawn")
        self._saved_env = _cpu_only_env()
        self._pool = ctx.Pool(
            num_workers, initializer=_init_worker, initargs=(dataset,)
        )

    def imap(self, epoch: int, indices):
        return self._pool.imap(
            _fetch, [(epoch, int(i)) for i in indices], chunksize=1
        )

    def close(self):
        if self._pool is None:
            return
        self._pool.terminate()
        self._pool.join()
        self._pool = None
        _restore_env(self._saved_env)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
