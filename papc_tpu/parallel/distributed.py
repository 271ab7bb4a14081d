"""Multi-host initialization (DP over DCN).

The reference is single-device only. Here, multi-host data parallelism
is the standard JAX recipe: call :func:`initialize` once per process
before any device use; after that ``jax.devices()`` spans every host's
GPUs and the existing mesh helpers produce global meshes — gradient
reductions are inserted by XLA from the same sharding annotations.
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Initialize jax.distributed (no-op if already initialized or when
    running single-process). Without a cluster environment JAX cannot
    discover the arguments: pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id``."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise


def is_main_process() -> bool:
    return jax.process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's row-slice of a globally sharded batch."""
    per = global_batch // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)


def all_mean(value, weight: float = 1.0) -> float:
    """Weighted mean of a per-process scalar across all processes — the
    collective-aware eval reduction (each host evaluates its shard, the
    metric is reduced over DCN). Single-process: returns the value.

    The reference has no analog (its eval is a single-device python
    loop); this is the ``process_allgather`` recipe from SURVEY §2.3.
    """
    if jax.process_count() == 1:
        return float(value)
    from jax.experimental import multihost_utils

    import numpy as np

    vw = multihost_utils.process_allgather(
        np.asarray([float(value) * weight, weight], np.float64)
    )  # [n_process, 2]
    total_w = vw[:, 1].sum()
    return float(vw[:, 0].sum() / max(total_w, 1e-12))
