"""Space-to-depth rewrite of the stride-2 3x3 BEV conv.

The RPN's block1 opens with a stride-2 3x3 conv on the [B, 496, 432, 64]
BEV canvas (reference ``models/bones/rpn.py:71-90``). The earlier
accelerator build found the strided backward (input-grad = dilated conv)
much slower than an equal-FLOP stride-1 conv; whether that holds on the
GPU is not measured.

The rewrite: pack 2x2 pixel patches into channels (space-to-depth) and
run ONE stride-1 2x2 VALID conv with the 3x3 kernel zero-expanded to
[2, 2, 4C, O] — identical math. The transform itself must stay OUT of
the hot path, so the BEV scatter writes the s2d canvas directly
(``ops.voxelize.scatter_to_bev_s2d``).

Geometry: the stride-2 conv's pad=1 is absorbed into the patch grid —
patch (r, s) covers input rows (2r-1, 2r) x cols (2s-1, 2s), giving a
[B, H/2+1, W/2+1, 4C] canvas whose 2x2 VALID windows are exactly the
3x3 stride-2 windows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def space_to_depth_bev(x: jax.Array) -> jax.Array:
    """[B, H, W, C] -> [B, H//2+1, W//2+1, 4C] (H, W even).

    Patch channel order: (row-in-patch, col-in-patch, C). Reference for
    tests/offline conversion only — the hot path scatters directly into
    this layout."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"H, W must be even, got {(h, w)}")
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    xp = xp.reshape(b, (h + 2) // 2, 2, (w + 2) // 2, 2, c)
    xp = xp.transpose(0, 1, 3, 2, 4, 5)
    return xp.reshape(b, (h + 2) // 2, (w + 2) // 2, 4 * c)


def expand_stride2_kernel(k: jax.Array) -> jax.Array:
    """[3, 3, C, O] stride-2 kernel -> [2, 2, 4C, O] stride-1 twin.

    K'[R, X, (py, px, c), o] = k[2R+py, 2X+px, c, o], zero where the tap
    falls outside the 3x3 (the dy=3 / dx=3 positions)."""
    if k.shape[:2] != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {k.shape}")
    c, o = k.shape[2], k.shape[3]
    kp = jnp.pad(k, ((0, 1), (0, 1), (0, 0), (0, 0)))  # [4, 4, C, O]
    kp = kp.reshape(2, 2, 2, 2, c, o)  # [R, py, X, px, C, O]
    kp = kp.transpose(0, 2, 1, 3, 4, 5)  # [R, X, py, px, C, O]
    return kp.reshape(2, 2, 4 * c, o)
