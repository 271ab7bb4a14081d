"""Farthest point sampling (FPS) — fully on-device.

The reference implements FPS as a Python loop that syncs the whole cloud to
numpy on EVERY iteration (``pointnet2_basic_layers.py:65-95`` — npoint
serialized host round-trips). Here the loop is a ``lax.fori_loop`` compiled
into the XLA program: the running min-distance vector stays on device, each
iteration is one gather + one fused elementwise pass + one argmax over
``[B, N]``.

On CUDA devices the whole loop runs instead as one Pallas-Triton program
per cloud (:mod:`papc_tpu.ops.pallas.fps`). The choice is made per
platform at lowering time, by ``fps_p``'s lowering rules: the kernel for
``cuda``, the plain loop for every other platform. An exported program
therefore carries the right version for each platform it was lowered for
(``lax.platform_dependent`` would do the same, but its conditional lowers
every branch for every platform, and a Triton ``pallas_call`` cannot be
lowered for the CPU), and no path runs the kernel in interpret mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.extend.core import Primitive
from jax.interpreters import batching, mlir

fps_p = Primitive("papc_fps")


def _fps_abstract(xyz, start, *, npoint):
    return jax.core.ShapedArray((xyz.shape[0], npoint), jnp.int32)


def _fps_triton(xyz, start, *, npoint):
    from papc_tpu.ops.pallas.fps import farthest_point_sample_triton

    return farthest_point_sample_triton(xyz, npoint, start)


def _fps_batch(args, dims, *, npoint):
    """vmap: fold the mapped axis into the cloud axis."""
    xyz, start = args
    xd, sd = dims
    v = xyz.shape[xd] if xd is not batching.not_mapped else start.shape[sd]
    xyz = (
        jnp.moveaxis(xyz, xd, 0) if xd is not batching.not_mapped
        else jnp.broadcast_to(xyz, (v,) + xyz.shape)
    )
    start = (
        jnp.moveaxis(start, sd, 0) if sd is not batching.not_mapped
        else jnp.broadcast_to(start, (v,) + start.shape)
    )
    _, b, n, c = xyz.shape
    out = fps_p.bind(
        xyz.reshape(v * b, n, c), start.reshape(v * b), npoint=npoint
    )
    return out.reshape(v, b, npoint), 0


fps_p.def_abstract_eval(_fps_abstract)
# eager calls compile the primitive alone, so they too take the
# lowering rule of the platform they run on
fps_p.def_impl(lambda xyz, start, *, npoint: jax.jit(
    lambda x, s: fps_p.bind(x, s, npoint=npoint))(xyz, start))
batching.primitive_batchers[fps_p] = _fps_batch
mlir.register_lowering(
    fps_p,
    mlir.lower_fun(
        lambda xyz, start, *, npoint: _fps_loop(xyz, start, npoint),
        multiple_results=False,
    ),
)
mlir.register_lowering(
    fps_p, mlir.lower_fun(_fps_triton, multiple_results=False),
    platform="cuda",
)


def farthest_point_sample(
    xyz: jax.Array,
    npoint: int,
    *,
    key: jax.Array | None = None,
    start_idx: jax.Array | int | None = None,
    backend: str | None = None,
) -> jax.Array:
    """Iteratively pick the point farthest from the already-picked set.

    Args:
      xyz: ``[B, N, 3]`` point positions.
      npoint: number of samples (static).
      key: optional PRNG key for the random initial point (the reference uses
        ``paddle.randint`` per batch item, ``pointnet2_basic_layers.py:76``).
      start_idx: optional fixed initial index (scalar or ``[B]``); wins over
        ``key``. Defaults to 0 when neither is given (deterministic).
      backend: ``"xla"`` (the plain loop) | ``"triton"`` (the Pallas-Triton
        kernel; CUDA only) | None (chosen per platform by ``fps_p``: the
        kernel on CUDA, the plain loop elsewhere).

    Returns:
      ``[B, npoint]`` int32 indices into ``N``.
    """
    B, N, _ = xyz.shape
    if start_idx is not None:
        start = jnp.broadcast_to(jnp.asarray(start_idx, jnp.int32), (B,))
    elif key is not None:
        start = jax.random.randint(key, (B,), 0, N, dtype=jnp.int32)
    else:
        start = jnp.zeros((B,), jnp.int32)

    if backend not in (None, "xla", "triton"):
        raise ValueError(f"unknown FPS backend {backend!r}")
    # no gradient flows through the integer picks
    xyz = lax.stop_gradient(xyz.astype(jnp.float32))
    with jax.named_scope("fps"):
        if backend == "xla":
            return _fps_loop(xyz, start, npoint)
        if backend == "triton":
            return _fps_triton(xyz, start, npoint=npoint)
        return fps_p.bind(xyz, start, npoint=npoint)


def _fps_loop(xyz: jax.Array, start: jax.Array, npoint: int):
    """The plain XLA loop: ``npoint`` rounds over ``[B, N]``."""
    B, N, _ = xyz.shape
    xyz = xyz.astype(jnp.float32)

    def body(i, state):
        distance, farthest, centroids = state
        centroids = lax.dynamic_update_index_in_dim(
            centroids, farthest, i, axis=1
        )
        centroid = jnp.take_along_axis(
            xyz, farthest[:, None, None], axis=1
        )  # [B, 1, 3]
        d = jnp.sum((xyz - centroid) ** 2, axis=-1)  # [B, N]
        distance = jnp.minimum(distance, d)
        farthest = jnp.argmax(distance, axis=-1).astype(jnp.int32)
        return distance, farthest, centroids

    distance0 = jnp.full((B, N), jnp.inf, dtype=jnp.float32)
    centroids0 = jnp.zeros((B, npoint), dtype=jnp.int32)
    _, _, centroids = lax.fori_loop(
        0, npoint, body, (distance0, start, centroids0)
    )
    return centroids
