"""PointPillars network (:mod:`papc_tpu.nn.core`, channel-last, batched
static shapes).

Reference parity: ``models/bones/pillars.py`` (PFNLayer, PillarFeatureNet,
PointPillarsScatter), ``models/bones/rpn.py`` (SECOND-style 3-block RPN),
``models/detectors/pointpillars.py`` (loss preparation).

Differences from the reference:
  * pillars are batched per sample ``[B, V, P, D]`` (the reference flattens
    the batch into one voxel list with a batch-index coordinate column);
  * the scatter is ONE flat indexed-set over batch-folded rows instead
    of a per-item numpy round-trip (reference ``pillars.py:121-142``);
  * NHWC layout; BN epsilons/momenta match the reference (1e-3 / 0.01).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from papc_tpu.nn import core as nn
from papc_tpu.ops.voxelize import (
    scatter_to_bev_batched,
    scatter_to_bev_s2d,
)

PFN_BN = dict(momentum=0.01, epsilon=1e-3)

# Deferred-upsample internal layout (see RPN): True runs the deconv→
# BN→ReLU→head segment on flattened-minor [b, h, w, s²·F] tensors —
# one matmul per stage — instead of 6-D [b, h, w, p, q, F] maps whose
# small q axis is minor-but-one. Kept parity-tested (tests/test_s2d.py)
# until its A/B on the GPU.
DEFERRED_FLAT_MINOR = False

# BatchNorm(dtype=None) PROMOTES its output to f32 (running stats are
# f32), so under bf16 compute every BN would re-inflate the activation
# stream — and every conv downstream of it — back to f32 traffic.
# dtype=x.dtype keeps the normalize output in the compute dtype;
# stats/running averages stay f32 either way. No effect in f32 mode.
BN_DTYPE_FOLLOWS_INPUT = True


def _bn_dtype(x):
    return x.dtype if BN_DTYPE_FOLLOWS_INPUT else None


class _DenseParams(nn.Module):
    """Parameter-only twin of ``nn.Dense`` (same names, shapes, inits)
    so the flat-points PFN keeps the classic PFN's param tree.
    ``use_bias=False`` mirrors ``nn.Dense(use_bias=False)`` (no bias
    param) and returns zeros."""

    features: int
    in_features: int
    use_bias: bool = True

    @nn.compact
    def __call__(self):
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (self.in_features, self.features),
        )
        if self.use_bias:
            bias = self.param(
                "bias", nn.initializers.zeros_init(), (self.features,)
            )
        else:
            bias = jnp.zeros((self.features,), jnp.float32)
        return kernel, bias


class _BNParams(nn.Module):
    """Parameter/stats-only twin of ``nn.BatchNorm`` (same tree)."""

    features: int

    @nn.compact
    def __call__(self):
        scale = self.param(
            "scale", nn.initializers.ones_init(), (self.features,)
        )
        bias = self.param(
            "bias", nn.initializers.zeros_init(), (self.features,)
        )
        ra_mean = self.variable(
            "batch_stats",
            "mean",
            lambda s: jnp.zeros(s, jnp.float32),
            (self.features,),
        )
        ra_var = self.variable(
            "batch_stats",
            "var",
            lambda s: jnp.ones(s, jnp.float32),
            (self.features,),
        )
        return scale, bias, ra_mean, ra_var


class _Conv2dParams(nn.Module):
    """Parameter-only twin of ``nn.Conv`` (same names, shapes, inits) so
    the RPN's space-to-depth branch can keep the reference-shaped
    ``[3, 3, C, O]`` kernel in the param tree while running the expanded
    stride-1 twin (``ops.s2d.expand_stride2_kernel``)."""

    features: int
    in_features: int
    kernel_size: tuple = (3, 3)
    use_bias: bool = True

    @nn.compact
    def __call__(self):
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (*self.kernel_size, self.in_features, self.features),
        )
        if self.use_bias:
            bias = self.param(
                "bias", nn.initializers.zeros_init(), (self.features,)
            )
        else:
            bias = None
        return kernel, bias


class PFNLayer(nn.Module):
    """Linear(no bias)→BN→ReLU→max over points; non-final layers concat
    the max back per point (reference ``pillars.py:9-41``)."""

    units: int
    last_layer: bool = False
    use_norm: bool = True

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = True) -> jax.Array:
        # x: [B, V, P, C]
        units = self.units if self.last_layer else self.units // 2
        x = nn.Dense(
            units, use_bias=not self.use_norm, name="Dense_0"
        )(x)
        if self.use_norm:
            x = nn.BatchNorm(
                use_running_average=not train, name="BatchNorm_0",
                dtype=_bn_dtype(x), **PFN_BN,
            )(x)
        x = nn.relu(x)
        x_max = jnp.max(x, axis=2, keepdims=True)  # [B, V, 1, units]
        if self.last_layer:
            return x_max
        rep = jnp.broadcast_to(x_max, x.shape)
        return jnp.concatenate([x, rep], axis=-1)


class PillarFeatureNet(nn.Module):
    """Decorate points (cluster offset + pillar-center offset), mask
    padded slots, run the PFN stack → per-pillar features
    (reference ``pillars.py:43-108``)."""

    num_filters: Sequence[int] = (64,)
    voxel_size: Sequence[float] = (0.2, 0.2, 4.0)
    pc_range: Sequence[float] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    with_distance: bool = False
    use_norm: bool = True

    @nn.compact
    def __call__(
        self,
        voxels: jax.Array,  # [B, V, P, D] raw point features (xyz first)
        num_points: jax.Array,  # [B, V] valid points per pillar
        coords: jax.Array,  # [B, V, 3] (z, y, x) cell indices; -1 invalid
        train: bool = True,
    ) -> jax.Array:
        B, V, P, D = voxels.shape
        denom = jnp.maximum(num_points, 1).astype(voxels.dtype)
        points_mean = (
            jnp.sum(voxels[..., :3], axis=2, keepdims=True)
            / denom[..., None, None]
        )
        f_cluster = voxels[..., :3] - points_mean

        vx, vy = float(self.voxel_size[0]), float(self.voxel_size[1])
        x_offset = vx / 2 + float(self.pc_range[0])
        y_offset = vy / 2 + float(self.pc_range[1])
        px = coords[..., 2].astype(voxels.dtype) * vx + x_offset
        py = coords[..., 1].astype(voxels.dtype) * vy + y_offset
        f_center = jnp.stack(
            [
                voxels[..., 0] - px[..., None],
                voxels[..., 1] - py[..., None],
            ],
            axis=-1,
        )
        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(
                jnp.linalg.norm(voxels[..., :3], axis=-1, keepdims=True)
            )
        features = jnp.concatenate(feats, axis=-1)

        # zero padded point slots (reference get_paddings_indicator)
        slot = jnp.arange(P)[None, None, :]
        mask = (slot < num_points[..., None]).astype(features.dtype)
        features = features * mask[..., None]

        n = len(self.num_filters)
        for i, f in enumerate(self.num_filters):
            features = PFNLayer(
                f, last_layer=(i == n - 1), use_norm=self.use_norm
            )(features, train)
        return features[:, :, 0, :]  # [B, V, C]


class PillarFeatureNetFlat(nn.Module):
    """Flat-points twin of :class:`PillarFeatureNet` (single PFN layer).

    Computes the PFN on the ~N real points (``points [B, N, D]`` +
    ``point_pillar [B, N]`` ownership) instead of the ``[B, V, P, D]``
    padded slot grid — at the KITTI workload that is ~20k points vs
    1.2M slots. Exact classic semantics (BN population, padded-slot max
    floor) live in :func:`papc_tpu.detect.pfn_fast.pfn_forward_flat`;
    this module only owns the param/stats tree, which is IDENTICAL to
    the classic module's (``PFNLayer_0/Dense_0`` + ``BatchNorm_0``
    twins), so checkpoints swap freely between the two."""

    num_filters: Sequence[int] = (64,)
    voxel_size: Sequence[float] = (0.2, 0.2, 4.0)
    pc_range: Sequence[float] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    with_distance: bool = False
    use_norm: bool = True
    max_points_per_pillar: int = 100

    @nn.compact
    def __call__(
        self,
        points: jax.Array,  # [B, N, D] flat real points, zero-pad rows
        point_pillar: jax.Array,  # [B, N] pillar row; -1 padding
        num_points: jax.Array,  # [B, V]
        coords: jax.Array,  # [B, V, 3]
        train: bool = True,
    ) -> jax.Array:
        from papc_tpu.detect.pfn_fast import pfn_forward_flat
        if len(self.num_filters) != 1 or not self.use_norm:
            raise NotImplementedError(
                "flat PFN covers the production single-layer/BN config; "
                "use the classic PillarFeatureNet otherwise"
            )
        c_in = points.shape[-1] + 5 + (1 if self.with_distance else 0)
        units = self.num_filters[0]

        class _Layer(nn.Module):
            @nn.compact
            def __call__(self):
                kernel, _ = _DenseParams(
                    units, c_in, use_bias=False, name="Dense_0"
                )()
                scale, bias, rm, rv = _BNParams(
                    units, name="BatchNorm_0"
                )()
                return kernel, scale, bias, rm, rv

        kernel, scale, bias, rm, rv = _Layer(name="PFNLayer_0")()
        out, new_running = pfn_forward_flat(
            kernel,
            scale,
            bias,
            (rm.value, rv.value),
            points,
            point_pillar,
            num_points,
            coords,
            self.max_points_per_pillar,
            voxel_size=tuple(self.voxel_size),
            pc_range=tuple(self.pc_range),
            with_distance=self.with_distance,
            train=train,
            momentum=PFN_BN["momentum"],
            eps=PFN_BN["epsilon"],
        )
        if train and not self.is_initializing():
            rm.value, rv.value = new_running
        return out


class PointPillarsScatter(nn.Module):
    """Scatter pillar features to the dense BEV canvas → [B, ny, nx, C]
    (reference ``pillars.py:110-142``; here ONE flat indexed-set over
    batch-folded rows — see ``scatter_to_bev_batched`` for why not
    ``vmap``)."""

    ny: int
    nx: int
    s2d: bool = False  # emit the space-to-depth canvas (see ops.s2d)

    @nn.compact
    def __call__(self, voxel_features, coords):
        if self.s2d:
            return scatter_to_bev_s2d(
                voxel_features, coords, self.ny, self.nx
            )
        return scatter_to_bev_batched(
            voxel_features, coords, self.ny, self.nx
        )


def _kron_eye_kernel(k: jax.Array, b: int) -> jax.Array:
    """Block-diagonal expansion of a conv kernel ``[kh, kw, Ci, Co]`` →
    ``[kh, kw, b*Ci, b*Co]`` so a batch-folded map ``[1, H, W, b*Ci]``
    (batch stacked on channels) convolves each fold group independently
    — exactly ``b`` parallel copies of the original conv. Autodiff of
    the expansion sums the diagonal blocks, i.e. the true kernel grad."""
    kh, kw, ci, co = k.shape
    e = jnp.eye(b, dtype=k.dtype)
    kf = k[:, :, None, :, None, :] * e[None, None, :, None, :, None]
    return kf.reshape(kh, kw, b * ci, b * co)


class _ConvBlock(nn.Module):
    """Stride conv + n same-padding convs, each Conv(no bias)→BN→ReLU.

    ``s2d_input=True`` takes the space-to-depth BEV canvas
    ``[B, H/2+1, W/2+1, 4C]`` instead of ``[B, H, W, C]`` and runs the
    opening stride-2 3x3 conv as its stride-1 2x2 VALID twin
    (:mod:`papc_tpu.ops.s2d`). The param tree keeps the reference-shaped
    ``[3, 3, C, O]`` kernel either way.

    ``batch_fold=True`` runs the post-opening Conv→BN→ReLU chain on the
    batch-FOLDED map ``[1, H, W, B*F]`` (batch stacked on channels, via
    :func:`_kron_eye_kernel` block-diagonal kernels and fold-pooled BN
    stats), so a narrow F < 128 channel axis becomes a B·F-wide one at
    the price of (half-zero) extra matmul work. Exact math; same param
    tree (twin modules)."""

    filters: int
    n_layers: int
    stride: int
    use_norm: bool = True
    use_groupnorm: bool = False
    num_groups: int = 32
    s2d_input: bool = False
    batch_fold: bool = False

    @nn.compact
    def __call__(self, x, train: bool = True):
        def bn(h):
            if self.use_groupnorm:
                h = nn.GroupNorm(
                    num_groups=min(self.num_groups, h.shape[-1]),
                    epsilon=1e-3,
                )(h)
            elif self.use_norm:
                h = nn.BatchNorm(
                    use_running_average=not train,
                    dtype=_bn_dtype(h), **PFN_BN,
                )(h)
            return h

        if self.s2d_input:
            if self.stride != 2:
                raise ValueError("s2d_input requires stride 2")
            from papc_tpu.ops.s2d import expand_stride2_kernel

            kernel, cbias = _Conv2dParams(
                self.filters, x.shape[-1] // 4,
                use_bias=not self.use_norm, name="Conv_0",
            )()
            x = jax.lax.conv_general_dilated(
                x, expand_stride2_kernel(kernel.astype(x.dtype)),
                (1, 1), "VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
            )
            if cbias is not None:
                x = x + cbias.astype(x.dtype)
        else:
            x = nn.Conv(
                self.filters, (3, 3), strides=self.stride,
                padding=((1, 1), (1, 1)), use_bias=not self.use_norm,
                name="Conv_0",
            )(x)
        fold = (
            self.batch_fold
            and self.use_norm
            and not self.use_groupnorm
            and x.shape[0] > 1
        )
        if fold:
            return self._folded_tail(x, train)
        x = nn.relu(bn(x))
        for i in range(self.n_layers):
            x = nn.Conv(
                self.filters, (3, 3), padding="SAME",
                use_bias=not self.use_norm, name=f"Conv_{i + 1}",
            )(x)
            x = nn.relu(bn(x))
        return x

    def _folded_tail(self, x, train):
        """BN_0→ReLU + the n same-padding Conv→BN→ReLU layers on the
        batch-folded ``[1, H, W, B*F]`` map (see class docstring).
        Exact: block-diagonal kernels, BN stats pooled across the fold
        groups per logical channel (the same element set BatchNorm reduces),
        shared Conv_i/BatchNorm_i param tree via the twin modules."""
        b, h, w, f = x.shape
        xf = x.transpose(1, 2, 0, 3).reshape(1, h, w, b * f)

        def fbn_relu(z, i):
            scale, bias, rm, rv = _BNParams(f, name=f"BatchNorm_{i}")()
            # per-(b·f)-channel moments over the NATIVE [1, h, w, b*f]
            # layout, then pool the b fold groups on the tiny [b, f]
            # tail, without reshaping the map to [h, w, b, f] (a full
            # f32 relayout of every BN input, fwd and bwd). Equal-count
            # groups make the pooled moments exact.
            zf = z.astype(jnp.float32)
            s1 = jnp.mean(zf, (0, 1, 2))  # [b*f]
            s2 = jnp.mean(jnp.square(zf), (0, 1, 2))  # [b*f]
            mean_b = jnp.mean(s1.reshape(b, f), 0)
            var_b = jnp.mean(s2.reshape(b, f), 0) - jnp.square(mean_b)
            if train:
                mean, var = mean_b, var_b
                if not self.is_initializing():
                    m = PFN_BN["momentum"]
                    rm.value = m * rm.value + (1 - m) * mean
                    rv.value = m * rv.value + (1 - m) * var
            else:
                mean, var = rm.value, rv.value
            inv = jax.lax.rsqrt(
                var + PFN_BN["epsilon"]
            ) * scale.astype(jnp.float32)
            mt = jnp.tile(mean.astype(z.dtype), b)
            it = jnp.tile(inv.astype(z.dtype), b)
            bt = jnp.tile(bias.astype(z.dtype), b)
            return nn.relu((z - mt) * it + bt)

        xf = fbn_relu(xf, 0)
        for i in range(self.n_layers):
            kernel, _ = _Conv2dParams(
                self.filters, f, use_bias=False, name=f"Conv_{i + 1}"
            )()
            xf = jax.lax.conv_general_dilated(
                xf,
                _kron_eye_kernel(kernel.astype(xf.dtype), b),
                (1, 1),
                ((1, 1), (1, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
            )
            xf = fbn_relu(xf, i + 1)
        return xf.reshape(h, w, b, f).transpose(2, 0, 1, 3)


class RPN(nn.Module):
    """SECOND-style 3-block backbone + upsample-concat + 1x1 heads
    (reference ``rpn.py:8-170``; ``use_groupnorm`` mirrors its
    GroupNorm-instead-of-BN option, rpn.py:41-43)."""

    num_class: int = 1
    layer_nums: Sequence[int] = (3, 5, 5)
    layer_strides: Sequence[int] = (2, 2, 2)
    num_filters: Sequence[int] = (64, 128, 256)
    upsample_strides: Sequence[int] = (1, 2, 4)
    num_upsample_filters: Sequence[int] = (128, 128, 128)
    num_anchor_per_loc: int = 2
    encode_background_as_zeros: bool = True
    use_direction_classifier: bool = True
    use_norm: bool = True
    use_groupnorm: bool = False
    num_groups: int = 32
    use_bev: bool = False
    box_code_size: int = 7
    s2d_input: bool = False  # x is the s2d canvas [B, ny/2+1, nx/2+1, 4C]
    # upsample via coarse-res 1x1 convs + depth-to-space of the tiny
    # head maps (exact; see the deferred-upsampling comment below)
    deferred_upsample: bool = False
    # run narrow (< 128-ch) conv blocks batch-folded (see _ConvBlock)
    batch_fold: bool = False

    @nn.compact
    def __call__(self, x, bev=None, train: bool = True):
        def bn(h):
            if self.use_groupnorm:
                h = nn.GroupNorm(
                    num_groups=min(self.num_groups, h.shape[-1]),
                    epsilon=1e-3,
                )(h)
            elif self.use_norm:
                h = nn.BatchNorm(
                    use_running_average=not train,
                    dtype=_bn_dtype(h), **PFN_BN,
                )(h)
            return h

        # deferred upsampling: the stride-s s×s ConvTranspose has NO
        # kernel overlap, so it is exactly a 1×1 conv to s²·F phase
        # channels at the coarse resolution; BatchNorm (per-channel,
        # phase-pooled stats), ReLU, and the linear heads all commute
        # with depth-to-space, so only the tiny head maps are ever
        # upsampled and the 164 MB [B, H, W, 384] concat map never
        # materializes. Exact math (CPU goldens); param tree unchanged
        # (ConvTranspose_i / BatchNorm_i twins).
        deferred = (
            self.deferred_upsample
            and self.use_norm
            and not self.use_groupnorm
            and not self.use_bev
        )

        ups = []  # classic: full-res activation maps
        acts = []  # deferred: ([B, h, w, s, s, F], s) coarse activations
        for i in range(3):
            x = _ConvBlock(
                self.num_filters[i],
                self.layer_nums[i],
                self.layer_strides[i],
                self.use_norm,
                self.use_groupnorm,
                self.num_groups,
                s2d_input=self.s2d_input and i == 0,
                batch_fold=self.batch_fold
                and self.num_filters[i] < 128,
            )(x, train)
            if i == 0 and self.use_bev and bev is not None:
                b = bev
                # log-compress the density channel (reference rpn.py:147)
                b = b.at[..., -1].set(
                    jnp.clip(jnp.log1p(b[..., -1]) / jnp.log(16.0), None, 1.0)
                )
                for f in (32, 64):
                    b = nn.Conv(
                        f, (3, 3), padding="SAME", use_bias=not self.use_norm
                    )(b)
                    b = nn.relu(bn(b))
                b = nn.max_pool(b, (2, 2), strides=(2, 2))
                x = jnp.concatenate([x, b], axis=-1)
            s = self.upsample_strides[i]
            f_up = self.num_upsample_filters[i]
            if deferred:
                kt, _ = _Conv2dParams(
                    f_up, x.shape[-1], kernel_size=(s, s),
                    use_bias=False, name=f"ConvTranspose_{i}",
                )()
                # z[b,h,w,p,q,o] = Σ_c x[b,h,w,c] k[s-1-p,s-1-q,c,o] —
                # the pre-depth-to-space deconv output
                # (lax.conv_transpose applies the kernel mirrored)
                km = kt[::-1, ::-1].astype(x.dtype)  # [s, s, c, f_up]
                if DEFERRED_FLAT_MINOR:
                    # flattened-minor [b, h, w, (p, q, o)]: one matmul
                    # (see toggle doc)
                    w2 = km.transpose(2, 0, 1, 3).reshape(
                        x.shape[-1], s * s * f_up
                    )
                    z = jnp.einsum("bhwc,cj->bhwj", x, w2)
                else:
                    z = jnp.einsum("bhwc,pqco->bhwpqo", x, km)
                scale, bbias, rm, rv = _BNParams(
                    f_up, name=f"BatchNorm_{i}"
                )()
                if train:
                    # per-channel moments over the leading axes in the
                    # NATIVE layout, then pool the s² phase groups on
                    # the tiny [s², f_up] tail (reshape(-1, f_up) first
                    # would relayout the whole f32 buffer). Equal-count
                    # groups → pooling exact.
                    zf = z.astype(jnp.float32)
                    axes = tuple(range(zf.ndim - 1))
                    s1 = jnp.mean(zf, axes)
                    s2 = jnp.mean(jnp.square(zf), axes)
                    if s1.shape[0] != f_up:  # flat-minor: [s²·f_up]
                        s1 = jnp.mean(s1.reshape(-1, f_up), 0)
                        s2 = jnp.mean(s2.reshape(-1, f_up), 0)
                    mean = s1
                    var = s2 - jnp.square(mean)
                    if not self.is_initializing():
                        m = PFN_BN["momentum"]
                        rm.value = m * rm.value + (1 - m) * mean
                        rv.value = m * rv.value + (1 - m) * var
                else:
                    mean, var = rm.value, rv.value
                inv = (
                    jax.lax.rsqrt(var + PFN_BN["epsilon"])
                    * scale.astype(jnp.float32)
                )
                mean_c = mean.astype(z.dtype)
                inv_c = inv.astype(z.dtype)
                bias_c = bbias.astype(z.dtype)
                if DEFERRED_FLAT_MINOR and s > 1:
                    mean_c = jnp.tile(mean_c, s * s)
                    inv_c = jnp.tile(inv_c, s * s)
                    bias_c = jnp.tile(bias_c, s * s)
                act = nn.relu((z - mean_c) * inv_c + bias_c)
                acts.append((act, s))
            else:
                up = nn.ConvTranspose(
                    f_up, (s, s), strides=(s, s),
                    use_bias=not self.use_norm,
                    name=f"ConvTranspose_{i}",
                )(x)
                ups.append(nn.relu(bn(up)))

        num_cls = self.num_anchor_per_loc * (
            self.num_class
            if self.encode_background_as_zeros
            else self.num_class + 1
        )
        # ONE fused 1x1 head conv instead of three: each separate head
        # re-reads the upsample-concat map forward AND emits its own
        # [B, H, W, 384] input-grad backward. Param tree keeps the
        # reference's three Conv_0/1/2 (same names/shapes/init),
        # weights concatenated at apply time.
        cin = sum(self.num_upsample_filters)
        n_box = self.num_anchor_per_loc * self.box_code_size
        n_dir = self.num_anchor_per_loc * 2
        kb, bb = _Conv2dParams(
            n_box, cin, kernel_size=(1, 1), name="Conv_0"
        )()
        kc, bc = _Conv2dParams(
            num_cls, cin, kernel_size=(1, 1), name="Conv_1"
        )()
        kernels = [kb[0, 0], kc[0, 0]]
        biases = [bb, bc]
        if self.use_direction_classifier:
            kd, bd = _Conv2dParams(
                n_dir, cin, kernel_size=(1, 1), name="Conv_2"
            )()
            kernels.append(kd[0, 0])
            biases.append(bd)
        w = jnp.concatenate(kernels, axis=-1)
        b = jnp.concatenate(biases)

        if deferred:
            # heads applied per resolution (head of a concat is a sum
            # of per-slice matmuls), then depth-to-space the TINY head
            # maps and sum
            h = None
            off = 0
            for idx, (act, s) in enumerate(acts):
                f_up = self.num_upsample_filters[idx]
                wi = w[off : off + f_up].astype(act.dtype)
                off += f_up
                if DEFERRED_FLAT_MINOR:
                    # block-diagonal head over the s² phase groups:
                    # ONE [s²·f_up → s²·O] matmul on the
                    # flattened-minor act
                    O_ = wi.shape[-1]
                    e = jnp.eye(s * s, dtype=wi.dtype)
                    wbd = (
                        e[:, None, :, None] * wi[None, :, None, :]
                    ).reshape(s * s * f_up, s * s * O_)
                    y = jnp.einsum("bhwj,jk->bhwk", act, wbd)
                    B_, hh, ww, _ = y.shape
                    y = y.reshape(B_, hh, ww, s, s, O_)
                else:
                    y = jnp.einsum("bhwpqo,of->bhwpqf", act, wi)
                    B_, hh, ww, _, _, O_ = y.shape
                y = y.transpose(0, 1, 3, 2, 4, 5).reshape(
                    B_, hh * s, ww * s, O_
                )
                h = y if h is None else h + y
            h = h + b.astype(h.dtype)
        else:
            x = jnp.concatenate(ups, axis=-1)
            wx = w.astype(x.dtype)
            h = jnp.einsum("bhwc,co->bhwo", x, wx) + b.astype(x.dtype)
        out = {
            "box_preds": h[..., :n_box],
            "cls_preds": h[..., n_box : n_box + num_cls],
        }
        if self.use_direction_classifier:
            out["dir_cls_preds"] = h[..., n_box + num_cls :]
        return out


class PointPillars(nn.Module):
    """PFN → Scatter → RPN. ``__call__`` returns the raw RPN head maps;
    loss and prediction post-processing are pure functions
    (``papc_tpu.detect.detector``)."""

    ny: int
    nx: int
    num_class: int = 1
    pfn_num_filters: Sequence[int] = (64,)
    voxel_size: Sequence[float] = (0.16, 0.16, 4.0)
    pc_range: Sequence[float] = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    with_distance: bool = False
    rpn_layer_nums: Sequence[int] = (3, 5, 5)
    rpn_layer_strides: Sequence[int] = (2, 2, 2)
    rpn_num_filters: Sequence[int] = (64, 128, 256)
    rpn_upsample_strides: Sequence[int] = (1, 2, 4)
    rpn_num_upsample_filters: Sequence[int] = (128, 128, 128)
    num_anchor_per_loc: int = 2
    encode_background_as_zeros: bool = True
    use_direction_classifier: bool = True
    use_norm: bool = True
    use_groupnorm: bool = False
    num_groups: int = 32
    box_code_size: int = 7
    # scatter straight into the space-to-depth canvas so the RPN's
    # opening stride-2 conv runs as its stride-1 2x2 twin (ops.s2d);
    # requires even ny/nx and layer_strides[0] == 2
    scatter_s2d: bool = False
    # run the PFN on flat real points when the batch carries them
    # (``points``/``point_pillar`` kwargs) — see PillarFeatureNetFlat
    pfn_flat: bool = False
    max_points_per_pillar: int = 100
    # RPN deferred upsampling (exact; see RPN.deferred_upsample)
    rpn_deferred_upsample: bool = False
    # batch-fold narrow RPN conv blocks (exact; see _ConvBlock)
    rpn_batch_fold: bool = False

    @nn.compact
    def __call__(
        self,
        voxels,
        num_points,
        coords,
        train: bool = True,
        points=None,
        point_pillar=None,
    ):
        if self.pfn_flat and points is not None:
            voxel_features = PillarFeatureNetFlat(
                num_filters=self.pfn_num_filters,
                voxel_size=self.voxel_size,
                pc_range=self.pc_range,
                with_distance=self.with_distance,
                use_norm=self.use_norm,
                max_points_per_pillar=self.max_points_per_pillar,
                name="pfn",
            )(points, point_pillar, num_points, coords, train)
        else:
            voxel_features = PillarFeatureNet(
                num_filters=self.pfn_num_filters,
                voxel_size=self.voxel_size,
                pc_range=self.pc_range,
                with_distance=self.with_distance,
                use_norm=self.use_norm,
                name="pfn",
            )(voxels, num_points, coords, train)
        use_s2d = (
            self.scatter_s2d
            and self.ny % 2 == 0
            and self.nx % 2 == 0
            and self.rpn_layer_strides[0] == 2
        )
        spatial = PointPillarsScatter(
            self.ny, self.nx, s2d=use_s2d, name="scatter"
        )(voxel_features, coords)
        return RPN(
            num_class=self.num_class,
            layer_nums=self.rpn_layer_nums,
            layer_strides=self.rpn_layer_strides,
            num_filters=self.rpn_num_filters,
            upsample_strides=self.rpn_upsample_strides,
            num_upsample_filters=self.rpn_num_upsample_filters,
            num_anchor_per_loc=self.num_anchor_per_loc,
            encode_background_as_zeros=self.encode_background_as_zeros,
            use_direction_classifier=self.use_direction_classifier,
            use_norm=self.use_norm,
            use_groupnorm=self.use_groupnorm,
            num_groups=self.num_groups,
            box_code_size=self.box_code_size,
            s2d_input=use_s2d,
            deferred_upsample=self.rpn_deferred_upsample,
            batch_fold=self.rpn_batch_fold,
            name="rpn",
        )(spatial, train=train)
