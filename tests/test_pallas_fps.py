"""Pallas-Triton FPS kernel vs the plain loop and the numpy oracle
(interpret mode on CPU), and the kernel choice per platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.export import DisabledSafetyCheck

from papc_tpu.ops.pallas.fps import farthest_point_sample_triton
from papc_tpu.ops.sampling import farthest_point_sample
from tests.oracles import farthest_point_sample_np


def _triton(xyz, npoint, start):
    B = xyz.shape[0]
    start = jnp.broadcast_to(jnp.asarray(start, jnp.int32), (B,))
    return np.asarray(
        farthest_point_sample_triton(xyz, npoint, start, interpret=True)
    )


@pytest.mark.parametrize("npoint", [1, 8, 64])
def test_matches_jnp_reference(rng, npoint):
    xyz = jnp.asarray(rng.randn(2, 128, 3), jnp.float32)
    want = np.asarray(farthest_point_sample(xyz, npoint, start_idx=0))
    np.testing.assert_array_equal(_triton(xyz, npoint, 0), want)


def test_start_idx_respected(rng):
    xyz = jnp.asarray(rng.randn(3, 64, 3), jnp.float32)
    got = _triton(xyz, 4, 7)
    np.testing.assert_array_equal(got[:, 0], [7, 7, 7])
    want = np.asarray(farthest_point_sample(xyz, 4, start_idx=7))
    np.testing.assert_array_equal(got, want)


def test_batch_blocking_and_padding(rng):
    """One program per cloud over an odd batch, with N padded from 96 to
    128: padded points must never be picked."""
    xyz = jnp.asarray(rng.randn(5, 96, 3) + 100.0, jnp.float32)
    want = np.asarray(farthest_point_sample(xyz, 16, start_idx=0))
    got = _triton(xyz, 16, 0)
    np.testing.assert_array_equal(got, want)
    assert got.max() < 96


def test_per_item_start_idx(rng):
    """Vector start_idx (the key=... path) round-trips per row."""
    xyz = jnp.asarray(rng.randn(4, 64, 3), jnp.float32)
    starts = jnp.asarray([3, 11, 0, 63], jnp.int32)
    got = _triton(xyz, 8, starts)
    np.testing.assert_array_equal(got[:, 0], np.asarray(starts))
    want = np.asarray(farthest_point_sample(xyz, 8, start_idx=starts))
    np.testing.assert_array_equal(got, want)


def test_backend_dispatch(rng):
    """On the CPU the automatic choice is the plain loop; the explicit
    backends agree, and an unknown one is refused."""
    xyz = jnp.asarray(rng.randn(2, 64, 3), jnp.float32)
    auto = np.asarray(farthest_point_sample(xyz, 8, start_idx=0))
    xla = np.asarray(farthest_point_sample(xyz, 8, start_idx=0, backend="xla"))
    np.testing.assert_array_equal(auto, xla)
    np.testing.assert_array_equal(auto, _triton(xyz, 8, 0))
    with pytest.raises(ValueError, match="backend"):
        farthest_point_sample(xyz, 8, backend="pallas")
    assert jax.default_backend() == "cpu"  # conftest forces CPU


@pytest.mark.parametrize(
    "B,N,npoint,start",
    [
        (1, 16, 16, 0),  # every point, smallest block
        (2, 100, 17, 5),  # N and npoint not powers of two
        (3, 257, 64, 256),  # N just past a power of two, last-point start
        (4, 512, 128, 1),  # the SSG SA2 shape, scaled down in batch
        (1, 1000, 100, 999),
        (2, 2048, 64, 3),  # 8 warps
        (1, 4100, 32, 4099),  # padded to 8192: 16 warps, last-point start
    ],
)
def test_matches_numpy_oracle(B, N, npoint, start):
    """Against the float32 numpy oracle over batch, cloud size (padded
    to a power of two inside the kernel), sample count and start."""
    x = np.random.RandomState(N).rand(B, N, 3).astype(np.float32) * 10
    want = farthest_point_sample_np(x, npoint, start)
    np.testing.assert_array_equal(_triton(jnp.asarray(x), npoint, start), want)


def test_duplicate_points_tie_to_first_index():
    """Exact ties (duplicated points) resolve to the lowest index, as
    ``jnp.argmax`` does in the plain loop."""
    base = np.random.RandomState(1).rand(1, 32, 3).astype(np.float32)
    x = jnp.asarray(np.concatenate([base, base], axis=1))
    want = np.asarray(farthest_point_sample(x, 24, start_idx=0, backend="xla"))
    got = _triton(x, 24, 0)
    np.testing.assert_array_equal(got, want)
    assert got.max() < 32


def test_fps_primitive_vmap_and_eager(rng):
    """``fps_p`` batches under ``vmap`` (extra leading axis folded into the
    cloud axis) and runs eagerly, matching the plain loop."""
    from papc_tpu.ops.sampling import fps_p

    xyz = jnp.asarray(rng.randn(3, 2, 40, 3), jnp.float32)
    starts = jnp.asarray(rng.randint(0, 40, (3, 2)), jnp.int32)
    got = jax.vmap(
        lambda x, s: farthest_point_sample(x, 6, start_idx=s)
    )(xyz, starts)
    want = np.stack([
        np.asarray(farthest_point_sample(xyz[i], 6, start_idx=starts[i],
                                         backend="xla"))
        for i in range(3)
    ])
    np.testing.assert_array_equal(np.asarray(got), want)
    eager = fps_p.bind(xyz[0], starts[0], npoint=6)
    np.testing.assert_array_equal(np.asarray(eager), want[0])


@pytest.mark.parametrize("platform,has_kernel", [("cuda", True), ("cpu", False)])
def test_platform_choice_in_lowering(platform, has_kernel):
    """``fps_p``'s lowering rules put the Triton kernel in the CUDA
    lowering and the plain loop everywhere else — also in one
    multi-platform export."""
    xyz = jnp.zeros((2, 64, 3), jnp.float32)
    exp = jax.export.export(
        jax.jit(lambda x: farthest_point_sample(x, 8)),
        platforms=[platform],
        disabled_checks=[
            DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(xyz)
    assert ("__gpu$xla.gpu.triton" in exp.mlir_module()) == has_kernel
    if platform == "cpu":
        np.testing.assert_array_equal(
            np.asarray(exp.call(xyz)),
            np.asarray(farthest_point_sample(xyz, 8, backend="xla")),
        )
