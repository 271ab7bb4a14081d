"""Gradient of the row gather ``index_points`` (XLA's scatter-add) vs
the numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from papc_tpu.ops.geometry import index_points
from tests.oracles import gather_rows_grad_np


def _grad(pts, idx, g):
    return np.asarray(
        jax.grad(lambda p: (index_points(p, idx) * g).sum())(pts)
    )


@pytest.mark.parametrize(
    "B,S,C,n_rows", [(2, 64, 8, 32), (3, 200, 131, 96), (1, 128, 3, 640)]
)
def test_scatter_matches_oracle(rng, B, S, C, n_rows):
    g = rng.randn(B, S, C).astype(np.float32)
    idx = rng.randint(0, n_rows, (B, S)).astype(np.int32)
    pts = jnp.zeros((B, n_rows, C), jnp.float32)
    # atol floor: the scatter-add sums duplicates in another order than
    # the sequential oracle (on the GPU, in an order that changes from
    # run to run), so near-cancelling sums carry f32 ulp noise
    np.testing.assert_allclose(
        _grad(pts, jnp.asarray(idx), jnp.asarray(g)),
        gather_rows_grad_np(g, idx, n_rows), rtol=1e-5, atol=1e-6,
    )


def test_scatter_ignores_padding_indices(rng):
    """Out-of-range indices clamp into range (like the forward gather),
    so their cotangent lands on the first / last row."""
    g = rng.randn(2, 32, 5).astype(np.float32)
    idx = np.full((2, 32), 3, np.int32)
    idx[0, :3] = [-1, 2, 99]
    pts = jnp.zeros((2, 16, 5), jnp.float32)
    got = _grad(pts, jnp.asarray(idx), jnp.asarray(g))
    want = gather_rows_grad_np(g, np.clip(idx, 0, 15), 16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[1, :3] == 0) and np.all(got[1, 4:] == 0)


def test_scatter_duplicate_heavy(rng):
    """Ball-query style duplicates: many S rows hitting one target row."""
    g = rng.randn(1, 256, 16).astype(np.float32)
    idx = jnp.zeros((1, 256), jnp.int32)  # everything lands on row 0
    got = _grad(jnp.zeros((1, 8, 16), jnp.float32), idx, jnp.asarray(g))
    np.testing.assert_allclose(got[0, 0], g[0].sum(0), rtol=1e-5, atol=1e-5)
    assert np.all(got[0, 1:] == 0)


def test_index_points_grad_cpu_path(rng):
    """Multi-axis indices ``[B, S, K]`` (the grouped SA layout)."""
    pts = jnp.asarray(rng.randn(2, 32, 7), jnp.float32)
    idx = jnp.asarray(rng.randint(0, 32, (2, 10, 4)), jnp.int32)
    w = jnp.asarray(rng.randn(2, 10, 4, 7), jnp.float32)
    want = gather_rows_grad_np(
        np.asarray(w.reshape(2, 40, 7)), np.asarray(idx.reshape(2, 40)), 32
    )
    np.testing.assert_allclose(_grad(pts, idx, w), want, rtol=1e-5, atol=1e-6)
