"""Scanned multi-step training (make_scan_train_step / train(scan_steps)).

The scanned program must be the SAME update as sequential stepping —
proved by replaying its rng schedule through the per-call step and
comparing final params — and the train() integration must learn and
handle the < K leftover tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from papc_tpu.data.synthetic import write_shapenet_h5
from papc_tpu.models import init_model
from papc_tpu.train.trainer import (
    create_train_state,
    make_scan_train_step,
    make_train_step,
    stack_batches,
    train,
)

N_POINTS = 64
NUM_CLASSES = 4


def _batches(rs, k, b=8):
    out = []
    for _ in range(k):
        out.append(
            {
                "points": rs.randn(b, N_POINTS, 3).astype(np.float32),
                "label": rs.randint(0, NUM_CLASSES, size=(b,)),
                "mask": np.ones((b,), bool),
            }
        )
    return out


def test_scan_equals_sequential():
    spec = init_model("pointnet2_ssg", "clas", num_classes=NUM_CLASSES)
    rs = np.random.RandomState(0)
    K = 4
    host_batches = _batches(rs, K)
    first = jax.tree_util.tree_map(jnp.asarray, host_batches[0])
    rng = jax.random.PRNGKey(7)
    state_a = create_train_state(spec, rng, first)
    state_b = jax.tree_util.tree_map(jnp.copy, state_a)

    scan_step = make_scan_train_step(spec, K)
    stacked = jax.tree_util.tree_map(
        jnp.asarray, stack_batches(host_batches)
    )
    base = jax.random.PRNGKey(123)
    state_a, losses, metrics = scan_step(state_a, stacked, base)
    assert losses.shape == (K,) and metrics.shape == (K,)

    train_step, _ = make_train_step(spec)
    r = base
    seq_losses = []
    for hb in host_batches:
        r, sub = jax.random.split(r)
        batch = jax.tree_util.tree_map(jnp.asarray, hb)
        state_b, loss, _ = train_step(state_b, batch, sub)
        seq_losses.append(float(loss))

    np.testing.assert_allclose(
        np.asarray(losses), np.asarray(seq_losses), rtol=1e-5, atol=1e-5
    )
    for (pa, a), b in zip(
        jax.tree_util.tree_leaves_with_path(state_a.params),
        jax.tree_util.tree_leaves(state_b.params),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
            err_msg=jax.tree_util.keystr(pa),
        )


def test_detection_scan_equals_sequential(rng):
    """Scanned PointPillars steps == sequential stepping (state, metrics,
    and the running-metric carry)."""
    from papc_tpu.detect import builders
    from papc_tpu.detect.config import (
        DEFAULT_CONFIG_PATH,
        cfg_from_yaml_file,
    )
    from papc_tpu.detect.train import (
        make_detection_train_step,
        make_scan_detection_train_step,
    )
    from papc_tpu.train.trainer import TrainState

    cfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH)
    cfg.VOXEL_GENERATOR.VOXEL_SIZE = [4.32, 4.96, 4]
    cfg.VOXEL_GENERATOR.MAX_VOXELS = 32
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides = [8.64, 9.92, 0.0]
    gen.offsets = [4.32, -34.72, -1.78]
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    model = builders.build_network(cfg, vg, ta)
    loss_cfg = builders.build_loss_config(cfg, ta)

    B, V, P, K = 2, 32, 8, 3
    grid = vg.grid_size
    A = (grid[0] // 2) * (grid[1] // 2) * 2

    def one_batch():
        return {
            "voxels": jnp.asarray(rng.randn(B, V, P, 4), jnp.float32),
            "num_points": jnp.asarray(
                rng.randint(1, P, (B, V)), jnp.int32),
            "coordinates": jnp.asarray(
                np.stack([np.zeros((B, V)),
                          rng.randint(0, grid[1], (B, V)),
                          rng.randint(0, grid[0], (B, V))], -1),
                jnp.int32),
            "anchors": jnp.asarray(np.tile(
                np.array([0.0, 0, -1, 1.6, 3.9, 1.56, 0], np.float32),
                (B, A, 1))),
            "labels": jnp.asarray(rng.randint(-1, 2, (B, A)), jnp.int32),
            "reg_targets": jnp.asarray(
                rng.randn(B, A, 7) * 0.1, jnp.float32),
        }

    batches = [one_batch() for _ in range(K)]
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *batches
    )
    variables = model.init(
        jax.random.PRNGKey(0), batches[0]["voxels"],
        batches[0]["num_points"], batches[0]["coordinates"], train=False,
    )

    def fresh_state():
        return TrainState.create(
            apply_fn=model.apply,
            params=jax.tree_util.tree_map(jnp.copy, variables["params"]),
            batch_stats=jax.tree_util.tree_map(
                jnp.copy, variables.get("batch_stats", {})),
            tx=builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER),
        )

    step, init_rm = make_detection_train_step(model, loss_cfg)
    scan_step = make_scan_detection_train_step(model, loss_cfg)

    state_a, mk, rm_a = scan_step(fresh_state(), stacked, init_rm())
    assert mk["loss"].shape == (K,)

    state_b, rm_b = fresh_state(), init_rm()
    seq_losses = []
    for b in batches:
        state_b, metrics, rm_b = step(state_b, b, rm_b)
        seq_losses.append(float(metrics["loss"]))

    # scan body vs unrolled step compile to different fusion orders;
    # Adam's rsqrt amplifies the reassociation drift over K chained
    # updates (observed ~8e-5 rel at step 3). A logic bug (wrong batch
    # order / rng / lr step) shows at >=1e-2, so drift-scale tolerance
    # still discriminates.
    np.testing.assert_allclose(
        np.asarray(mk["loss"]), seq_losses, rtol=5e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        float(rm_a["pr"].precision[2]), float(rm_b["pr"].precision[2]),
        rtol=1e-6,
    )
    # Param comparison is distributional, not elementwise: where Adam's
    # v is ~0 the reassociation drift can flip an update's sign, moving
    # isolated elements by a few full updates (observed 5e-4 on 0.01%
    # of a ConvTranspose kernel; one update ~= the 2e-4 yaml lr). A
    # logic bug (wrong batch order / carry) moves a large FRACTION of
    # elements by update scale, so bound the tail fraction and the max.
    for (pa, a), b in zip(
        jax.tree_util.tree_leaves_with_path(state_a.params),
        jax.tree_util.tree_leaves(state_b.params),
    ):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        name = jax.tree_util.keystr(pa)
        assert d.max() < 1.5e-3, (name, d.max())
        frac = float((d > 2.5e-4).mean())
        assert frac < 1e-2, (name, frac, d.max())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("shapenet_scan")
    write_shapenet_h5(
        str(path), n_train=40, n_test=8, n_val=8, n_points=N_POINTS,
        num_classes=NUM_CLASSES, num_parts=8,
    )
    return str(path)


def test_train_with_scan_steps_learns(dataset, tmp_path):
    # batchsize 16 over 40 samples -> 2 full stacks of K=1... use
    # K=2: 2 scanned calls + 1 leftover single step per epoch
    logs = []
    state, history = train(
        model_name="pointnet_basic",
        mode="clas",
        max_point=N_POINTS,
        num_classes=NUM_CLASSES,
        num_parts=8,
        learning_rate=1e-3,
        weight_decay=1e-4,
        epoch_num=3,
        batchsize=16,
        info_iter=2,
        save_iter=2,
        path=dataset,
        model_dir=str(tmp_path / "model"),
        scan_steps=2,
        log=logs.append,
    )
    assert history[-1]["val_loss"] < history[0]["val_loss"] * 1.5
    assert history[-1]["val_metric"] > 0.3
    assert any("loss is" in line for line in logs)
