"""KD-Net classifier: axis-conditioned convolutions over a balanced kd-tree.

Reference parity: ``PAPC/models/classify/kdnet/kdnet.py`` — 10 ``kdconv``
levels halving 1024→1 leaf groups with per-level feature widths
(32,64,64,128,128,256,256,512,512,128) and a final FC head.

Each kdconv: Dense to ``3*featdim`` channels (one feature bank per split
axis), select the bank matching each position's kd split dimension, then
max-pool sibling pairs. The select is a 3-way masked sum over the bank
axis — NOT a ``take_along_axis``: with only 3 banks the mask form is
3 fused selects, where a batched gather (and its scatter backward)
compiles to much heavier code.

Deviation (documented): the reference flattens ``[3, dim]`` and indexes it
with ``split + 3*arange(dim)`` (``kdnet.py:27-28``) which scrambles
(bank, position) pairs — a translation bug of the original KD-Net
selection. We implement the intended semantics: position ``j`` selects
bank ``split[j]``.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn

KDNET_WIDTHS = (32, 64, 64, 128, 128, 256, 256, 512, 512, 128)


def kd_select_pool(h: jax.Array, split: jax.Array) -> jax.Array:
    """Select per-position axis bank and max-pool sibling pairs.

    Args:
      h: ``[B, dim, 3, F]`` per-axis feature banks.
      split: ``[B, dim]`` int split-axis per position (siblings share).

    Returns:
      ``[B, dim // 2, F]``.
    """
    B, dim, _, F = h.shape
    sel = split[:, :, None].astype(jnp.int32)  # [B, dim, 1]
    x = jnp.where(
        sel == 0,
        h[:, :, 0, :],
        jnp.where(sel == 1, h[:, :, 1, :], h[:, :, 2, :]),
    )
    x = x.reshape(B, dim // 2, 2, F)
    return jnp.max(x, axis=2)


class KDConv(nn.Module):
    """One KD-Net level: Dense(3F) → ReLU → axis select → pair max."""

    featdim: int
    use_bn: bool = False  # KDNet: no BN (reference); KDUNet levels: BN

    @nn.compact
    def __call__(self, x, split, train: bool = True):
        B, dim, _ = x.shape
        h = nn.Dense(3 * self.featdim)(x)
        if self.use_bn:
            h = nn.BatchNorm(
                use_running_average=not train, momentum=0.9, epsilon=1e-5
            )(h)
        h = nn.relu(h)
        h = h.reshape(B, dim, 3, self.featdim)
        return kd_select_pool(h, split)


class KDNet(nn.Module):
    num_classes: int = 16

    @nn.compact
    def __call__(
        self,
        points: jax.Array,
        split_dims: Sequence[jax.Array],
        train: bool = True,
    ) -> jax.Array:
        """points ``[B, N, 3]`` (N a power of two); split_dims: log2(N)
        arrays, level l shaped ``[B, N >> l]`` → logits
        ``[B, num_classes]``. With N=1024 the widths match the reference
        exactly; shallower trees use a truncated progression ending at the
        128-wide FC input."""
        import math

        levels = int(math.log2(points.shape[1]))
        widths = (
            KDNET_WIDTHS
            if levels == len(KDNET_WIDTHS)
            else KDNET_WIDTHS[: levels - 1] + (128,)
        )
        x = points
        for level, width in enumerate(widths):
            x = KDConv(width)(x, split_dims[level], train)
        x = x.reshape(x.shape[0], widths[-1])
        return nn.Dense(self.num_classes)(x)
