"""Pallas-Triton kernel: farthest point sampling, one program per cloud.

The plain loop (``papc_tpu.ops.sampling``) compiles to an XLA while-loop
of ``npoint`` sequential rounds, each a few tiny ``[B, N]`` kernels, so
it is bound by launch latency (512 + 128 rounds per SSG step). This
kernel runs the whole selection loop inside one program per cloud, the
standard PointNet++ CUDA design:

* the cloud's coordinates and its running min-distance stay on chip for
  the whole loop (registers; ``N`` padded to a power of two, padded
  points carry distance -1 so the argmax never picks them);
* each round loads the last pick's coordinates (three scalar loads that
  hit L1), updates the min-distance elementwise and takes a block argmax
  (first index on ties, like ``jnp.argmax``).

At 16k points the cloud no longer fits in the register file and spills
to local memory; that still beat keeping the min-distance in a device
memory scratch row walked tile by tile (5.13 against 17.0 ms at
4×16384→2048 on an H100 SXM at a 400 W power limit), so there is one
variant.

Distances are computed elementwise, never as a matmul, so TF32 cannot
touch them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _sq_dist(x, y, z, cx, cy, cz):
    dx, dy, dz = x - cx, y - cy, z - cz
    return dx * dx + dy * dy + dz * dz


def _fps_kernel(x_ref, y_ref, z_ref, start_ref, out_ref, *,
                n: int, npoint: int):
    # x/y/z_ref: [Np] one cloud, zero-padded; start_ref: [1]; out_ref:
    # [npoint_p]. Everything stays in registers across the loop.
    np_ = x_ref.shape[0]
    x, y, z = x_ref[...], y_ref[...], z_ref[...]
    lane = lax.broadcasted_iota(jnp.int32, (np_,), 0)
    dist0 = jnp.where(lane < n, jnp.inf, -1.0).astype(jnp.float32)

    def body(i, carry):
        far, dist = carry
        out_ref[i] = far
        d = _sq_dist(x, y, z, x_ref[far], y_ref[far], z_ref[far])
        dist = jnp.minimum(dist, d)
        return jnp.argmax(dist).astype(jnp.int32), dist

    lax.fori_loop(0, npoint, body, (start_ref[0], dist0))


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _num_warps(np_: int) -> int:
    """About 32 registers of cloud state per thread, 4 to 16 warps."""
    return min(16, max(4, np_ // 256))


@functools.partial(jax.jit, static_argnames=("npoint", "interpret"))
def farthest_point_sample_triton(
    xyz: jax.Array,
    npoint: int,
    start_idx: jax.Array,
    interpret: bool = False,
) -> jax.Array:
    """Triton FPS: ``xyz [B, N, 3]``, ``start_idx [B]`` → ``[B, npoint]``.

    Same min-distance/argmax recursion as the plain loop in
    :func:`papc_tpu.ops.sampling.farthest_point_sample`.
    """
    B, N, _ = xyz.shape
    np_ = _next_pow2(max(N, 16))
    npoint_p = _next_pow2(max(npoint, 16))
    planes = [
        jnp.pad(lax.stop_gradient(xyz[..., c]).astype(jnp.float32),
                ((0, 0), (0, np_ - N)))
        for c in range(3)
    ]
    start = jnp.broadcast_to(
        jnp.asarray(start_idx, jnp.int32), (B,)
    ).reshape(B, 1)
    row = pl.BlockSpec((None, np_), lambda b: (b, 0))
    out = pl.pallas_call(
        functools.partial(_fps_kernel, n=N, npoint=npoint),
        grid=(B,),
        in_specs=[row, row, row, pl.BlockSpec((None, 1), lambda b: (b, 0))],
        out_specs=pl.BlockSpec((None, npoint_p), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct((B, npoint_p), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(np_), num_stages=1
        ),
        interpret=interpret,
        name="fps",
    )(*planes, start)
    return out[:, :npoint]
