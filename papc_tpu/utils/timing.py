"""Device timing primitives for benchmarks.

JAX dispatches asynchronously: a jitted call returns before the device
has finished, so a timer must end on a barrier. A VALUE FETCH
(``np.asarray`` / ``float``) is one: it cannot complete before the
producing computation has. On the GPU ``block_until_ready`` is one too.

:func:`fetch_forced_time` runs K chained steps, forces the final value,
and takes the slope between a small and a large K — the constant
fetch+dispatch overhead cancels, leaving per-step device time. The two
window sizes make the estimate self-checking: if the windows don't
scale with K the slope collapses toward zero and
:func:`fetch_forced_time` falls back to the conservative whole-window
bound.

:func:`check_physical` is the physics guard: a measured step time that
implies more FLOP/s than the card's published peak is *proof* of a
broken timer. Peaks come from :data:`PEAK_FLOPS`, keyed by the JAX
``device_kind``; a device that is not in the table is an error, never a
default.

The reference has no analog — its timers
(``detect/train.py:208-226``) accumulate raw wall-clock deltas without
even accounting for ordinary CUDA async dispatch.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import jax
import numpy as np

# Published dense peaks (no sparsity) in FLOP/s, keyed by
# ``jax.devices()[0].device_kind``. Source: NVIDIA H100 data sheet, SXM
# part, at its full 700 W power limit (a card set lower cannot hold its
# top clock under load). "tf32" is a float32 matmul on the tensor cores,
# "fp32" float32 outside them.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12},
}


def peak_flops(precision: str, device_kind: str | None = None) -> float:
    """Published peak of ``device_kind`` (default: the first device) at
    ``precision``; raises for a device or precision not in the table."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAK_FLOPS[device_kind][precision]
    except KeyError:
        raise KeyError(
            f"no published {precision!r} peak for device kind "
            f"{device_kind!r}; known: {sorted(PEAK_FLOPS)}"
        ) from None


def force(x, *, all_leaves: bool = False):
    """Force a concrete value fetch — a barrier on any backend.

    Fetches the smallest array leaf of ``x`` (or every leaf when
    ``all_leaves``). For outputs of a single jitted step (the donated
    train-step pattern) the executable completes as a unit before any
    output can transfer, so one leaf is a barrier for the whole step.

    Returns ``x`` so it can wrap expressions.
    """
    leaves = [
        leaf
        for leaf in jax.tree_util.tree_leaves(x)
        if hasattr(leaf, "__array__") or hasattr(leaf, "addressable_shards")
    ]
    if not leaves:
        return x
    if not all_leaves:
        leaves = [min(leaves, key=lambda leaf: getattr(leaf, "size", 0))]
    for leaf in leaves:
        np.asarray(leaf)
    return x


@dataclass
class TimingResult:
    """Per-step time plus the evidence it was derived from."""

    step_s: float
    method: str  # "k-slope" | "window-bound"
    k_small: int
    k_large: int
    windows_small: list = field(default_factory=list)
    windows_large: list = field(default_factory=list)

    @property
    def step_ms(self) -> float:
        return self.step_s * 1e3


def fetch_forced_time(
    step,
    *,
    k_small: int = 10,
    k_large: int = 40,
    repeats: int = 3,
    warmup: bool = True,
) -> TimingResult:
    """Per-step device time of ``step`` via fetch-forced K-chain slope.

    ``step()`` must advance its own state (holder pattern, chained
    through donated buffers) and return something whose value depends on
    the step — typically the loss. Each window dispatches K steps and
    then FORCES the final value; per-step time is the slope between the
    best small and best large window, cancelling the constant
    fetch+dispatch overhead. Using the best (min) window per K is
    deliberate: host contention inflates whole windows at once, and the
    fastest sustained window is the steadiest estimate of device
    capability.

    Falls back to the whole-window upper bound ``min(T_large)/k_large``
    (marked ``method="window-bound"``) if noise swamps the slope — that
    bound still contains the real step time and can only overstate it.
    """
    if k_large <= k_small:
        raise ValueError("k_large must exceed k_small")
    if warmup:
        force(step())

    def window(k: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = step()
        force(out)
        return time.perf_counter() - t0

    ws, wl = [], []
    for _ in range(repeats):
        ws.append(window(k_small))
        wl.append(window(k_large))
    slope = (min(wl) - min(ws)) / (k_large - k_small)
    bound = min(wl) / k_large
    if slope <= 0 or not math.isfinite(slope):
        return TimingResult(bound, "window-bound", k_small, k_large, ws, wl)
    return TimingResult(slope, "k-slope", k_small, k_large, ws, wl)


def scan_slope(time_for_k, k_small: int, k_large: int) -> TimingResult:
    """Per-step time from whole-call times of K-step scanned programs.

    ``time_for_k(k)`` returns the (already fetch-forced, best-of) whole
    call time of a program that runs ``k`` steps inside one jit. The
    per-step estimate is the slope between the two K's — constant
    per-call overhead (dispatch, fetch) cancels. Shares
    :func:`fetch_forced_time`'s self-check: host noise can make
    the windows non-monotone in K, in which case the slope is
    non-positive and we fall back to the conservative whole-window
    bound ``time_for_k(k_large)/k_large`` (method="window-bound"),
    which contains the true step time and can only overstate it. A
    non-positive number must never enter the record.
    """
    if k_large <= k_small:
        raise ValueError("k_large must exceed k_small")
    t_small = time_for_k(k_small)
    t_large = time_for_k(k_large)
    slope = (t_large - t_small) / (k_large - k_small)
    if slope <= 0 or not math.isfinite(slope):
        return TimingResult(
            t_large / k_large, "window-bound", k_small, k_large,
            [t_small], [t_large],
        )
    return TimingResult(
        slope, "k-slope", k_small, k_large, [t_small], [t_large]
    )


def compiled_flops(fn, *args, **kwargs) -> float | None:
    """FLOPs of ``fn(*args, **kwargs)`` per XLA ``cost_analysis``.

    ``fn`` may already be jitted; returns None when the backend offers
    no cost model (e.g. some CPU builds).
    """
    try:
        lowered = (fn if hasattr(fn, "lower") else jax.jit(fn)).lower(
            *args, **kwargs
        )
        cost = lowered.compile().cost_analysis()
        flops = cost.get("flops")
        return float(flops) if flops else None
    except Exception:  # noqa: BLE001 — cost model is best-effort
        return None


def mfu(
    flops_per_step: float | None,
    step_s: float,
    precision: str = "bf16",
    device_kind: str | None = None,
) -> float | None:
    """FLOP utilization against the published peak for ``precision``."""
    if not flops_per_step or step_s <= 0:
        return None
    return flops_per_step / step_s / peak_flops(precision, device_kind)


def check_physical(
    step_s: float,
    flops_per_step: float | None,
    label: str = "",
    precision: str = "bf16",
    device_kind: str | None = None,
) -> float:
    """Refuse physically impossible timings (the broken-timer guard).

    A step time implying >100% of chip peak cannot be a measurement;
    raises so a broken timer can never put a number in the record.
    Returns the implied MFU (0.0 when FLOPs are unknown).
    """
    if step_s <= 0 or not math.isfinite(step_s):
        raise RuntimeError(
            f"physically impossible timing for {label or 'step'}: "
            f"non-positive/non-finite step time {step_s!r} s implies "
            "infinite throughput — the timer (or a K-slope without its "
            "window-bound fallback) is broken"
        )
    u = mfu(flops_per_step, step_s, precision, device_kind)
    if u is None:
        return 0.0
    if u > 1.0:
        raise RuntimeError(
            f"physically impossible timing for {label or 'step'}: "
            f"{step_s * 1e3:.3f} ms at {flops_per_step:.3g} FLOPs implies "
            f"{u * 100:.0f}% of the published {precision} peak — the "
            "timer is broken (does it end on a barrier?)"
        )
    return u
