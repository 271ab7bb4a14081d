"""Ball query (the plain ``[B, S, N]`` distance + ``top_k`` path, and
its query-chunked twin) vs the numpy oracle — exact index equality."""

import jax.numpy as jnp
import numpy as np
import pytest

from papc_tpu.ops import grouping
from tests.oracles import query_ball_point_np


def _clouds(rng, B, N, S):
    xyz = rng.randn(B, N, 3).astype(np.float32)
    # queries are actual points (reference invariant: new_xyz ⊆ xyz)
    qi = rng.choice(N, size=(B, S))
    new_xyz = np.stack([xyz[b, qi[b]] for b in range(B)])
    return xyz, new_xyz


@pytest.mark.parametrize(
    "B,N,S,nsample,radius",
    [
        (2, 256, 64, 8, 0.5),  # mixed fill levels
        (1, 300, 70, 16, 0.3),  # non-aligned N/S
        (2, 128, 32, 4, 3.0),  # every ball overfull
    ],
)
def test_matches_jnp_path(rng, B, N, S, nsample, radius):
    xyz, new_xyz = _clouds(rng, B, N, S)
    want = query_ball_point_np(radius, nsample, xyz, new_xyz)
    got = np.asarray(
        grouping.query_ball_point(
            radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz)
        )
    )
    np.testing.assert_array_equal(got, want)
    tiled = np.asarray(
        grouping.query_ball_point_tiled(
            radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz),
            query_chunk=32,
        )
    )
    np.testing.assert_array_equal(tiled, want)


def test_empty_ball_clamps(rng):
    """Queries far from every point (a case the reference cannot hit,
    since its queries are cloud points): every slot clamps to N-1."""
    xyz = rng.randn(1, 128, 3).astype(np.float32)
    far = np.full((1, 16, 3), 100.0, np.float32)
    got = np.asarray(
        grouping.query_ball_point(0.5, 8, jnp.asarray(xyz), jnp.asarray(far))
    )
    assert (got == 127).all()
