"""papc_tpu.utils.timing — the timer must end on a real barrier.

The central hazard these tests encode: JAX dispatch is asynchronous, so a
timer that reads the clock before the device has finished measures
dispatch rate, not device time. ``FakeAsyncArray`` models the worst case
— a ``block_until_ready`` that returns at once, real cost only on value
fetch — and the tests assert that ``fetch_forced_time`` recovers the
true per-step time where such a timer would report ~zero. The peak table
and the physics guard are checked against the H100's published rates.
"""

import time

import numpy as np
import pytest

from papc_tpu.utils.timing import (
    TimingResult,
    check_physical,
    compiled_flops,
    fetch_forced_time,
    force,
    mfu,
)


class VirtualClock:
    """Deterministic stand-in for ``time`` (perf_counter only): slope
    tests must not depend on real sleeps, which CPU contention in CI
    inflates arbitrarily (observed: a 2 ms sleep taking 3.4 ms under a
    concurrent full-suite run)."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def advance(self, dt):
        self.now += dt


class FakeAsyncDevice:
    """Models asynchronous dispatch: dispatch is free, the value fetch pays
    for every step still in flight. With a VirtualClock, costs advance the clock
    deterministically instead of really sleeping."""

    def __init__(self, step_cost_s, clock=None):
        self.step_cost_s = step_cost_s
        self.pending = 0
        self.clock = clock

    def _pay(self, seconds):
        if self.clock is not None:
            self.clock.advance(seconds)
        else:
            time.sleep(seconds)

    def step(self):
        self.pending += 1
        return FakeAsyncArray(self)


class FakeAsyncArray:
    size = 1
    shape = ()

    def __init__(self, device):
        self._device = device

    def block_until_ready(self):  # the trap: returns immediately
        return self

    def __array__(self, dtype=None, copy=None):
        # the fetch drains everything dispatched so far
        self._device._pay(self._device.pending * self._device.step_cost_s)
        self._device.pending = 0
        return np.zeros((), np.float32)


STEP_COST = 2e-3


def test_block_until_ready_based_timing_would_lie():
    """Baseline: a timer that trusts this ``block_until_ready`` reports
    ~0 on the fake device."""
    dev = FakeAsyncDevice(STEP_COST)
    t0 = time.perf_counter()
    out = None
    for _ in range(20):
        out = dev.step()
    out.block_until_ready()
    apparent = (time.perf_counter() - t0) / 20
    assert apparent < STEP_COST / 4  # the lie this module exists to kill


def test_fetch_forced_time_recovers_true_step_cost(monkeypatch):
    clock = VirtualClock()
    monkeypatch.setattr("papc_tpu.utils.timing.time", clock)
    dev = FakeAsyncDevice(STEP_COST, clock=clock)
    res = fetch_forced_time(dev.step, k_small=5, k_large=20, repeats=2)
    assert isinstance(res, TimingResult)
    assert res.method == "k-slope"
    assert res.step_s == pytest.approx(STEP_COST, rel=0.05)


def test_fetch_forced_time_cancels_constant_overhead(monkeypatch):
    """A large per-fetch constant (a host round-trip) must not leak into
    the per-step estimate."""
    clock = VirtualClock()
    monkeypatch.setattr("papc_tpu.utils.timing.time", clock)
    dev = FakeAsyncDevice(STEP_COST, clock=clock)
    real_step = dev.step

    def step_with_costly_fetch():
        out = real_step()
        out_fetch = out.__array__

        def fetch(dtype=None, copy=None):
            clock.advance(10e-3)  # constant per-window fetch cost
            return out_fetch(dtype)

        out.__array__ = fetch
        return out

    res = fetch_forced_time(
        step_with_costly_fetch, k_small=5, k_large=20, repeats=2
    )
    # naive window mean would report STEP_COST + 10ms/5 = 2x the truth
    assert res.step_s == pytest.approx(STEP_COST, rel=0.05)


def test_fetch_forced_time_window_bound_fallback():
    """Zero-cost steps: slope ~0 → conservative window bound, never a
    negative or nonsensical number."""

    def instant_step():
        return np.zeros(())

    res = fetch_forced_time(instant_step, k_small=2, k_large=8, repeats=1)
    assert res.step_s >= 0
    assert res.method in ("k-slope", "window-bound")


def test_force_fetches_smallest_leaf():
    dev = FakeAsyncDevice(STEP_COST)
    arr = dev.step()
    assert dev.pending == 1
    force({"loss": arr, "plain": 3})
    assert dev.pending == 0  # fetched → drained


def test_force_passthrough_non_arrays():
    assert force(5) == 5
    assert force(None) is None


H100 = "NVIDIA H100 80GB HBM3"


def test_check_physical_rejects_impossible_time():
    # 1e12 FLOPs in 1 µs = 1000 PFLOP/s — no chip does that
    with pytest.raises(RuntimeError, match="physically impossible"):
        check_physical(1e-6, 1e12, label="unit-test", device_kind=H100)


def test_check_physical_accepts_real_time_and_returns_mfu():
    u = check_physical(1e-3, 9.89e10, precision="bf16", device_kind=H100)
    assert u == pytest.approx(0.1, rel=1e-6)
    assert check_physical(1.0, None) == 0.0


def test_mfu_basic():
    assert mfu(989e12, 1.0, "bf16", H100) == pytest.approx(1.0)
    assert mfu(495e12, 2.0, "tf32", H100) == pytest.approx(0.5)
    assert mfu(None, 1.0) is None


@pytest.mark.parametrize(
    "precision,flops", [("bf16", 989e12), ("tf32", 495e12), ("fp32", 67e12)]
)
def test_peak_table_h100(precision, flops):
    from papc_tpu.utils.timing import peak_flops

    assert peak_flops(precision, H100) == flops


@pytest.mark.parametrize(
    "kind,precision",
    [("cpu", "bf16"), ("NVIDIA A100-SXM4-80GB", "bf16"), (H100, "fp8")],
)
def test_peak_table_refuses_unknown(kind, precision):
    """No peak is ever assumed: an unknown device kind or precision is
    an error, and so is a physics check that needs one."""
    from papc_tpu.utils.timing import peak_flops

    with pytest.raises(KeyError, match="no published"):
        peak_flops(precision, kind)
    with pytest.raises(KeyError):
        check_physical(1e-3, 1e9, precision=precision, device_kind=kind)


def test_compiled_flops_counts_a_matmul():
    import jax
    import jax.numpy as jnp

    a = jnp.ones((128, 128), jnp.float32)
    f = compiled_flops(lambda x: x @ x, a)
    if f is not None:  # CPU backends may lack a cost model
        assert f >= 2 * 128**3 * 0.9


def test_steptimer_window_amortizes_fetch():
    """sync_every=k: one fetch per k steps, window attributed evenly —
    per-step estimate stays near truth instead of truth+fetch RTT."""
    from papc_tpu.utils.profiling import StepTimer

    dev = FakeAsyncDevice(STEP_COST)
    t = StepTimer(sync_every=5)
    results = []
    for _ in range(10):
        t.start()
        out = dev.step()
        results.append(t.stop(out))
    assert results[:4] == [None] * 4 and results[4] is not None
    assert dev.pending == 0
    assert t.count == 10
    assert t.avg == pytest.approx(STEP_COST, rel=0.5)
    # explicit sync override wins over the policy
    t2 = StepTimer(sync_every=100)
    t2.start()
    out = dev.step()
    assert t2.stop(out, sync=True) is not None
    t2.start()
    dev.step()
    t2.discard()
    assert t2._pending == 0 and t2._t0 is None


def test_steptimer_forces_fetch():
    from papc_tpu.utils.profiling import StepTimer

    dev = FakeAsyncDevice(STEP_COST)
    t = StepTimer()
    t.start()
    out = dev.step()
    dt = t.stop(out)
    assert dev.pending == 0  # the timer actually fetched
    assert dt >= STEP_COST * 0.5
    assert t.avg == pytest.approx(dt)


def test_scan_slope_k_slope_and_window_bound_fallback():
    from papc_tpu.utils.timing import scan_slope

    # clean case: whole-call time = 1ms overhead + 2ms/step
    res = scan_slope(lambda k: 1e-3 + 2e-3 * k, 8, 32)
    assert res.method == "k-slope"
    assert res.step_s == pytest.approx(2e-3)
    # congested case: the large window came back FASTER than the small
    # one (host noise) -> slope is negative; must fall back to the
    # conservative whole-window bound, never record a non-positive time
    times = {8: 50e-3, 32: 40e-3}
    res = scan_slope(lambda k: times[k], 8, 32)
    assert res.method == "window-bound"
    assert res.step_s == pytest.approx(40e-3 / 32)
    assert res.step_s > 0
    with pytest.raises(ValueError):
        scan_slope(lambda k: k * 1e-3, 8, 8)


def test_check_physical_rejects_nonpositive_time():
    from papc_tpu.utils.timing import check_physical

    for bad in (0.0, -1e-3, float("nan"), float("inf")):
        with pytest.raises(RuntimeError):
            check_physical(bad, 1e9, "neg")
    # even with unknown FLOPs, a non-positive time must raise
    with pytest.raises(RuntimeError):
        check_physical(-1e-3, None, "neg-noflops")
