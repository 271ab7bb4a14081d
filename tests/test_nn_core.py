"""The in-repo module layer (papc_tpu.nn.core) against flax.linen: same
variable trees, same initial values, same outputs and BatchNorm updates.

flax is a test-time reference only; the package itself never imports it.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

linen = pytest.importorskip("flax.linen")

from papc_tpu.nn import core  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNGS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


def _layer(nn, kind):
    """One small module per layer kind, written once for either API."""

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, train=True):
            if kind == "dense":
                return nn.Dense(7)(x)
            if kind == "dense_nobias_bf16":
                return nn.Dense(7, use_bias=False)(x.astype(jnp.bfloat16))
            if kind == "conv_stride_pad":
                return nn.Conv(6, (3, 3), strides=2,
                               padding=((1, 1), (1, 1)))(x)
            if kind == "conv_same_3d":
                return nn.Conv(4, (3, 3, 3), padding="VALID")(x)
            if kind == "conv_transpose":
                return nn.ConvTranspose(5, (2, 2), strides=(2, 2),
                                        use_bias=False)(x)
            if kind == "conv_transpose_1d":
                return nn.ConvTranspose(5, kernel_size=(2,),
                                        strides=(2,))(x)
            if kind == "batchnorm":
                return nn.BatchNorm(use_running_average=not train,
                                    momentum=0.9, epsilon=1e-5)(x)
            if kind == "batchnorm_dtype":
                return nn.BatchNorm(use_running_average=not train,
                                    momentum=0.99, epsilon=1e-3,
                                    dtype=jnp.bfloat16)(x)
            if kind == "groupnorm":
                return nn.GroupNorm(num_groups=2, epsilon=1e-3)(x)
            if kind == "groupnorm_bf16_in":
                return nn.GroupNorm(num_groups=3)(x.astype(jnp.bfloat16))
            if kind == "conv_1d":
                return nn.Conv(5, (3,), padding="SAME")(x)
            if kind == "dense_4d":
                return nn.Dense(9)(x)
            if kind == "batchnorm_bf16_in":
                return nn.BatchNorm(use_running_average=not train,
                                    momentum=0.9)(x.astype(jnp.bfloat16))
            if kind == "dropout":
                return nn.Dropout(0.5, deterministic=not train)(x)
            if kind == "max_pool":
                return nn.max_pool(nn.Dense(4)(x), (2, 2), strides=(2, 2))
            if kind == "stack":
                h = nn.relu(nn.BatchNorm(use_running_average=not train,
                                         momentum=0.9)(nn.Dense(8)(x)))
                h = nn.Dropout(0.3, deterministic=not train)(h)
                return nn.Dense(3, name="head")(h)
            raise ValueError(kind)

    return Net()


INPUTS = {
    "dense": (4, 5),
    "dense_nobias_bf16": (4, 5),
    "conv_stride_pad": (2, 8, 8, 3),
    "conv_same_3d": (2, 6, 6, 6, 2),
    "conv_transpose": (2, 4, 4, 3),
    "conv_transpose_1d": (2, 6, 3),
    "batchnorm": (4, 3, 6),
    "batchnorm_dtype": (4, 3, 6),
    "groupnorm": (2, 4, 4, 6),
    "groupnorm_bf16_in": (2, 3, 3, 6),
    "conv_1d": (2, 10, 4),
    "dense_4d": (2, 3, 5, 4),
    "batchnorm_bf16_in": (2, 5, 6),
    "dropout": (4, 16),
    "max_pool": (2, 4, 6, 3),
    "stack": (6, 5),
}


def _tree_equal(a, b, atol=0.0):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert [jax.tree_util.keystr(k) for k, _ in la] == [
        jax.tree_util.keystr(k) for k, _ in lb
    ]
    for (k, x), (_, y) in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_allclose(
            np.asarray(x, np.float32), np.asarray(y, np.float32),
            atol=atol, rtol=0, err_msg=jax.tree_util.keystr(k),
        )


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_layer_matches_linen(kind):
    x = jnp.asarray(
        np.random.RandomState(0).randn(*INPUTS[kind]) * 2 + 0.5,
        jnp.float32,
    )
    vf = _layer(linen, kind).init(RNGS, x, train=False)
    vc = _layer(core, kind).init(RNGS, x, train=False)
    _tree_equal(vf, vc)  # same paths, shapes, dtypes and initial values
    for train in (False, True):
        kw = dict(train=train, rngs={"dropout": jax.random.PRNGKey(3)})
        if "batch_stats" in vf and train:
            of, mf = _layer(linen, kind).apply(
                vf, x, mutable=["batch_stats"], **kw)
            oc, mc = _layer(core, kind).apply(
                vf, x, mutable=["batch_stats"], **kw)
            _tree_equal(dict(mf), mc)
        else:
            of = _layer(linen, kind).apply(vf, x, **kw)
            oc = _layer(core, kind).apply(vf, x, **kw)
        assert of.dtype == oc.dtype
        np.testing.assert_array_equal(
            np.asarray(of, np.float32), np.asarray(oc, np.float32)
        )


def _linen_module(relpath, extra=None):
    """Execute a repo model file with ``nn`` bound to flax.linen."""
    src = (ROOT / relpath).read_text()
    src = src.replace("from papc_tpu.nn import core as nn",
                      "from flax import linen as nn")
    name = "linen_twin_" + relpath.replace("/", "_").removesuffix(".py")
    mod = types.ModuleType(name)
    mod.__dict__.update(extra or {})
    sys.modules[name] = mod  # dataclasses resolve annotations through it
    exec(compile(src, f"linen:{relpath}", "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("train", [False, True])
def test_pointmlp_and_heads_match_linen(train):
    """The repo's own PointMLP / MLPHead / TNet, executed once with the
    in-repo layer and once with linen: same trees, values and outputs."""
    from papc_tpu.nn import layers

    twin = _linen_module("papc_tpu/nn/layers.py")
    x = jnp.asarray(np.random.RandomState(1).randn(2, 16, 3), jnp.float32)

    for a, b in ((layers.PointMLP((8, 16)), twin.PointMLP((8, 16))),
                 (layers.TNet(3), twin.TNet(3)),
                 (layers.MLPHead((8,), 4, dropout_rate=0.5, bn=True),
                  twin.MLPHead((8,), 4, dropout_rate=0.5, bn=True))):
        inp = x if not isinstance(a, layers.MLPHead) else x[:, 0]
        va = a.init(RNGS, inp, train=False)
        vb = b.init(RNGS, inp, train=False)
        _tree_equal(vb, va)
        kw = dict(rngs={"dropout": jax.random.PRNGKey(2)},
                  mutable=["batch_stats"])
        oa, ma = a.apply(va, inp, train=train, **kw)
        ob, mb = b.apply(va, inp, train=train, **kw)
        np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))
        _tree_equal(dict(mb), ma)


def test_pointpillars_matches_linen():
    """The whole PointPillars network (classic PFN, s2d canvas, batch-
    folded and deferred RPN paths) at a tiny grid."""
    from papc_tpu.detect import model as core_model

    twin = _linen_module("papc_tpu/detect/model.py")
    kw = dict(ny=16, nx=16, pfn_num_filters=(8,), rpn_layer_nums=(1, 1, 1),
              rpn_num_filters=(8, 8, 16), rpn_num_upsample_filters=(8, 8, 8),
              voxel_size=(0.5, 0.5, 4.0), pc_range=(0, -4, -3, 8, 4, 1),
              scatter_s2d=True, rpn_deferred_upsample=True,
              rpn_batch_fold=True)
    rs = np.random.RandomState(0)
    B, V, P = 2, 20, 6
    voxels = jnp.asarray(rs.randn(B, V, P, 4), jnp.float32)
    num_points = jnp.asarray(rs.randint(1, P, (B, V)), jnp.int32)
    coords = jnp.asarray(np.stack(
        [np.zeros((B, V)), rs.randint(0, 16, (B, V)),
         rs.randint(0, 16, (B, V))], -1), jnp.int32)
    a, b = core_model.PointPillars(**kw), twin.PointPillars(**kw)
    va = a.init(RNGS, voxels, num_points, coords, train=False)
    vb = b.init(RNGS, voxels, num_points, coords, train=False)
    _tree_equal(vb, va)
    oa, ma = a.apply(va, voxels, num_points, coords, train=True,
                     mutable=["batch_stats"])
    ob, mb = b.apply(va, voxels, num_points, coords, train=True,
                     mutable=["batch_stats"])
    _tree_equal(ob, oa)
    _tree_equal(dict(mb), ma)


def test_immutable_collection_and_missing_param_are_errors():
    net = _layer(core, "batchnorm")
    x = jnp.ones((4, 3))
    v = net.init(RNGS, x, train=False)
    with pytest.raises(ValueError, match="immutable"):
        net.apply(v, x, train=True)  # BN update without mutable=
    with pytest.raises(ValueError, match="missing"):
        net.apply({"batch_stats": v["batch_stats"]}, x, train=False)
    with pytest.raises(ValueError, match="not bound"):
        core.Dense(3)(x)
