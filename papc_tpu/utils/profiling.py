"""Profiling and step-timing utilities.

The reference only accumulates wall-clock deltas
(``detectors/pointpillars.py:39-41,400-406``, ``train.py:208-226``) —
and does so WITHOUT accounting for async dispatch. Here:

  * :class:`StepTimer` FORCES a value fetch on a representative output
    before reading the clock (see :mod:`papc_tpu.utils.timing`), so
    measured step times are real device times;
  * :func:`trace` wraps ``jax.profiler`` for on-demand XLA traces
    (viewable in TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import time

import jax

from papc_tpu.utils.timing import force


class StepTimer:
    """Running average step timer that respects async dispatch.

    A syncing ``stop`` fetches the smallest array leaf of the given
    outputs. For a single jitted train step that one fetch is a barrier
    for the whole step, and for a scalar loss it costs one 4-byte
    transfer.

    A fetch stalls the dispatch pipeline, so ``sync_every=k``
    amortizes: only every k-th ``stop`` forces, and the measured window
    (first ``start`` after a sync → forcing ``stop``) is attributed
    evenly to the steps inside it. Between-step host time inside a
    window (data loading) is included — window averages are
    throughput-true. Pass ``sync=True/False`` to override the policy
    per call (e.g. sync exactly on display steps).
    """

    def __init__(self, sync_every: int = 1):
        self.total = 0.0
        self.count = 0
        self.sync_every = sync_every
        self.last = None  # most recent window's per-step seconds
        self._t0 = None
        self._pending = 0

    def start(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def stop(self, *block_on, sync: bool | None = None, steps: int = 1):
        """End one step (or a scanned call of ``steps`` steps). On sync
        steps, force a fetch and return the window's per-step seconds;
        otherwise return None."""
        self._pending += steps
        if sync is None:
            sync = self._pending >= self.sync_every
        if not sync:
            return None
        force(block_on)
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += self._pending
        self.last = dt / self._pending
        self._pending = 0
        self._t0 = None
        return self.last

    def discard(self):
        """Drop the open window (call after eval/checkpoint pauses so
        their wall time is not attributed to train steps)."""
        self._pending = 0
        self._t0 = None

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace around a code block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region for profiler timelines."""
    with jax.profiler.TraceAnnotation(name):
        yield
