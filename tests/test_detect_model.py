"""PointPillars network + loss + predict tests (tiny shapes, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from papc_tpu.detect import box_np
from papc_tpu.detect.box_coder import GroundBox3dCoder
from papc_tpu.detect.detector import (
    LossConfig,
    PredictConfig,
    add_sin_difference,
    compute_loss,
    get_direction_target,
    predict,
    prepare_loss_weights,
)
from papc_tpu.detect.model import PointPillars

# tiny scene: 16 x 16 BEV grid, 32 pillars, 8 points per pillar
NY, NX, V, P = 16, 16, 32, 8
B = 2
KEY = jax.random.PRNGKey(0)


def make_inputs(rng):
    voxels = rng.randn(B, V, P, 4).astype(np.float32)
    num_points = rng.randint(1, P + 1, size=(B, V)).astype(np.int32)
    coords = np.stack(
        [
            np.zeros((B, V), np.int32),
            rng.randint(0, NY, size=(B, V)),
            rng.randint(0, NX, size=(B, V)),
        ],
        axis=-1,
    ).astype(np.int32)
    return jnp.asarray(voxels), jnp.asarray(num_points), jnp.asarray(coords)


@pytest.fixture(scope="module")
def net_and_vars():
    rng = np.random.RandomState(0)
    model = PointPillars(ny=NY, nx=NX, num_class=1)
    inputs = make_inputs(rng)
    variables = model.init(KEY, *inputs, train=False)
    return model, variables, inputs


def test_forward_shapes(net_and_vars):
    model, variables, inputs = net_and_vars
    out = model.apply(variables, *inputs, train=False)
    # strides 2,2,2 w/ upsample 1,2,4 -> all maps at ny/2 x nx/2
    H, W = NY // 2, NX // 2
    assert out["box_preds"].shape == (B, H, W, 2 * 7)
    assert out["cls_preds"].shape == (B, H, W, 2 * 1)
    assert out["dir_cls_preds"].shape == (B, H, W, 2 * 2)


def test_prepare_loss_weights():
    labels = jnp.asarray([[1, 0, -1, 1, 0, 0]])
    cls_w, reg_w, cared = prepare_loss_weights(labels)
    np.testing.assert_array_equal(
        np.asarray(cared), [[True, True, False, True, True, True]]
    )
    # NormByNumPositives: 2 positives -> reg weight 0.5 on positives
    np.testing.assert_allclose(
        np.asarray(reg_w), [[0.5, 0, 0, 0.5, 0, 0]]
    )
    # reference quirk (detectors/pointpillars.py:487): cls weight =
    # neg_w + pos_w*positives for ALL anchors (incl. ignored), then
    # normalized by num positives — positives 2/2=1, others 1/2
    np.testing.assert_allclose(np.asarray(cls_w[0, 0]), 1.0)
    np.testing.assert_allclose(np.asarray(cls_w[0, 2]), 0.5)


def test_sin_difference_identity():
    a = jnp.asarray(np.random.RandomState(0).randn(1, 4, 7), jnp.float32)
    b1, b2 = add_sin_difference(a, a)
    # sin(x)cos(x) == cos(x)sin(x) -> angle channels equal
    np.testing.assert_allclose(
        np.asarray(b1[..., -1]), np.asarray(b2[..., -1]), atol=1e-6
    )


def test_direction_target():
    anchors = jnp.zeros((1, 3, 7)).at[..., -1].set(
        jnp.asarray([[0.5, -0.5, 0.0]])
    )
    reg = jnp.zeros((1, 3, 7)).at[..., -1].set(
        jnp.asarray([[0.1, 0.1, -0.2]])
    )
    t = get_direction_target(anchors, reg, one_hot=False)
    np.testing.assert_array_equal(np.asarray(t), [[1, 0, 0]])


@pytest.mark.parametrize("ncls", [1, 3])
@pytest.mark.parametrize(
    "norm", ["NormByNumExamples", "NormByNumPositives", "NormByNumPosNeg"]
)
@pytest.mark.parametrize("use_dir", [True, False])
def test_loss_ca_layout_matches_bac_oracle(ncls, norm, use_dir):
    """compute_loss ([B, C, A] layout) vs compute_loss_bac
    (reference [B, A, C] layout oracle): same math, reduction order
    only."""
    from papc_tpu.detect.detector import compute_loss_bac

    rng = np.random.RandomState(7 + ncls)
    H, W, na = 6, 5, 2
    A = H * W * na
    preds = {
        "box_preds": jnp.asarray(
            rng.randn(B, H, W, na * 7).astype(np.float32)
        ),
        "cls_preds": jnp.asarray(
            rng.randn(B, H, W, na * ncls).astype(np.float32)
        ),
    }
    if use_dir:
        preds["dir_cls_preds"] = jnp.asarray(
            rng.randn(B, H, W, na * 2).astype(np.float32)
        )
    labels = jnp.asarray(rng.randint(-1, ncls + 1, size=(B, A)))
    reg_targets = jnp.asarray(
        (rng.randn(B, A, 7) * 0.3).astype(np.float32)
    )
    anchors = jnp.asarray(rng.randn(B, A, 7).astype(np.float32))
    cfg = LossConfig(
        num_class=ncls,
        loss_norm_type=norm,
        use_direction_classifier=use_dir,
        pos_cls_weight=1.5,
        neg_cls_weight=0.8,
        code_weights=tuple(float(w) for w in 0.5 + rng.rand(7)),
    )
    l_new, m_new = jax.jit(
        lambda: compute_loss(preds, labels, reg_targets, anchors, cfg)
    )()
    l_old, m_old = jax.jit(
        lambda: compute_loss_bac(preds, labels, reg_targets, anchors, cfg)
    )()
    np.testing.assert_allclose(
        float(l_new), float(l_old), rtol=1e-5, atol=1e-6
    )
    assert set(m_new) == set(m_old)
    for k in m_old:
        np.testing.assert_allclose(
            np.asarray(m_new[k], np.float64),
            np.asarray(m_old[k], np.float64),
            rtol=1e-5,
            atol=1e-6,
            err_msg=k,
        )


def test_loss_ca_layout_accepts_flat_preds():
    """compute_loss also accepts pre-flattened [B, A, C] head tensors
    (the form experiments and external callers may pass)."""
    from papc_tpu.detect.detector import compute_loss_bac

    rng = np.random.RandomState(3)
    A = 40
    preds = {
        "box_preds": jnp.asarray(rng.randn(B, A, 7).astype(np.float32)),
        "cls_preds": jnp.asarray(rng.randn(B, A, 1).astype(np.float32)),
        "dir_cls_preds": jnp.asarray(
            rng.randn(B, A, 2).astype(np.float32)
        ),
    }
    labels = jnp.asarray(rng.randint(-1, 2, size=(B, A)))
    reg_targets = jnp.asarray(
        (rng.randn(B, A, 7) * 0.3).astype(np.float32)
    )
    anchors = jnp.asarray(rng.randn(B, A, 7).astype(np.float32))
    cfg = LossConfig()
    l_new, _ = compute_loss(preds, labels, reg_targets, anchors, cfg)
    l_old, _ = compute_loss_bac(preds, labels, reg_targets, anchors, cfg)
    np.testing.assert_allclose(
        float(l_new), float(l_old), rtol=1e-5, atol=1e-6
    )


def test_loss_runs_and_grads(net_and_vars):
    model, variables, inputs = net_and_vars
    rng = np.random.RandomState(1)
    H, W = NY // 2, NX // 2
    A = H * W * 2
    labels = jnp.asarray(rng.randint(-1, 2, size=(B, A)))
    reg_targets = jnp.asarray(rng.randn(B, A, 7) * 0.1, jnp.float32)
    anchors = jnp.asarray(
        np.tile(
            np.array([0.0, 0, -1, 1.6, 3.9, 1.56, 0], np.float32),
            (B, A, 1),
        )
    )
    cfg = LossConfig()

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *inputs, train=True, mutable=["batch_stats"],
        )
        loss, m = compute_loss(out, labels, reg_targets, anchors, cfg)
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    assert np.isfinite(float(loss))
    gnorm = sum(
        float(jnp.sum(jnp.abs(g)))
        for g in jax.tree_util.tree_leaves(grads)
    )
    assert gnorm > 0


def test_predict_static_shapes(net_and_vars):
    model, variables, inputs = net_and_vars
    out = model.apply(variables, *inputs, train=False)
    H, W = NY // 2, NX // 2
    A = H * W * 2
    anchors_np = box_np.create_anchors_3d_stride(
        [1, H, W],
        anchor_strides=[2 * 0.16, 2 * 0.16, 0.0],
        anchor_offsets=[0.16, -39.52, -1.78],
    ).reshape(-1, 7)
    anchors = jnp.asarray(np.tile(anchors_np[None], (B, 1, 1)))
    coder = GroundBox3dCoder()
    cfg = PredictConfig(
        nms_pre_max_size=64, nms_post_max_size=16,
        nms_score_threshold=0.0,
    )
    dets = predict(out, anchors, coder.decode_jnp, cfg)
    assert dets["box3d_lidar"].shape == (B, 16, 7)
    assert dets["scores"].shape == (B, 16)
    assert dets["valid"].shape == (B, 16)
    # valid detections carry finite boxes
    assert bool(jnp.isfinite(dets["box3d_lidar"]).all())


def test_predict_score_threshold_filters_all(net_and_vars):
    model, variables, inputs = net_and_vars
    out = model.apply(variables, *inputs, train=False)
    H, W = NY // 2, NX // 2
    A = H * W * 2
    anchors = jnp.asarray(
        np.tile(np.array([0.0, 0, -1, 1.6, 3.9, 1.56, 0], np.float32),
                (B, A, 1))
    )
    coder = GroundBox3dCoder()
    cfg = PredictConfig(
        nms_pre_max_size=64, nms_post_max_size=16,
        nms_score_threshold=1.1,  # impossible
    )
    dets = predict(out, anchors, coder.decode_jnp, cfg)
    assert int(dets["valid"].sum()) == 0


def test_predict_bf16_matches_fp32(net_and_vars):
    """make_predict_step(precision='bf16') casts the network forward to
    bf16 (decode/NMS stay f32) and reproduces fp32 detections within
    bf16 tolerance."""
    from papc_tpu.detect.box_coder import GroundBox3dCoder
    from papc_tpu.detect.train import TrainState, make_predict_step
    from papc_tpu.detect.detector import PredictConfig
    import optax

    model, variables, inputs = net_and_vars
    state = TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=optax.sgd(1e-3),
    )
    rng = np.random.RandomState(0)
    A = NY // 2 * (NX // 2) * 2
    batch = {
        "voxels": inputs[0],
        "num_points": inputs[1],
        "coordinates": inputs[2],
        "anchors": jnp.asarray(
            np.tile(
                np.array([0.0, 0, -1, 1.6, 3.9, 1.56, 0], np.float32),
                (B, A, 1),
            )
        ),
    }
    pcfg = PredictConfig(nms_pre_max_size=50, nms_post_max_size=10)
    coder = GroundBox3dCoder()
    step32 = make_predict_step(model, pcfg, coder)
    step16 = make_predict_step(model, pcfg, coder, precision="bf16")
    out32 = step32(state, batch)
    out16 = step16(state, batch)
    assert out32["box3d_lidar"].shape == out16["box3d_lidar"].shape
    assert np.isfinite(np.asarray(out16["scores"])).all()
    # scores of kept boxes agree to bf16 tolerance where both kept
    s32 = np.sort(np.asarray(out32["scores"]).ravel())
    s16 = np.sort(np.asarray(out16["scores"]).ravel())
    np.testing.assert_allclose(s16, s32, rtol=0.1, atol=0.05)
