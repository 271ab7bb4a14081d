"""KD-UNet part segmentation: kd-tree encoder + transposed-conv decoder.

Reference parity: ``PAPC/models/segment/kdunet/kdunet.py`` — 5 kdconv
downsample levels (widths 32,64,256,512,1024, each ConvBNReLU) with
shortcuts, then 5 ConvTranspose(k=2,s=2) upsample levels with
skip-concat + double conv, final 1x1 conv to classes.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.models.classify.kdnet import KDConv
from papc_tpu.nn import PointMLP

KDUNET_WIDTHS = (32, 64, 256, 512, 1024)


class KDUNet(nn.Module):
    num_classes: int = 50

    @nn.compact
    def __call__(
        self,
        points: jax.Array,
        split_dims: Sequence[jax.Array],
        train: bool = True,
    ) -> jax.Array:
        """points ``[B, 1024, 3]``; split_dims: ≥5 arrays, level l shaped
        ``[B, 1024 >> l]`` → per-point logits ``[B, 1024, num_classes]``."""
        x = points
        shortcuts = []
        for level, width in enumerate(KDUNET_WIDTHS):
            shortcuts.append(x)
            x = KDConv(width, use_bn=True)(x, split_dims[level], train)

        # decoder: (deconv channels, double-conv channels) per level —
        # reference kdunet.py:76-96
        deconv_ch = (512, 512, 256, 256, 128)
        double_ch = ((512, 512), (512, 512), (256, 256), (128, 128), None)
        for i in range(5):
            # ConvTranspose over the points axis: length doubles
            x = nn.ConvTranspose(
                deconv_ch[i], kernel_size=(2,), strides=(2,)
            )(x)
            x = jnp.concatenate([x, shortcuts[-(i + 1)]], axis=-1)
            if i < 4:
                x = PointMLP(double_ch[i])(x, train)
            else:
                x = PointMLP((128,))(x, train)
                x = nn.Dense(self.num_classes)(x)
        return x
