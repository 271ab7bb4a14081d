"""Detection training loop + CLI.

Reference parity: ``pointpillars/train.py`` — config-driven build of
voxelizer/coder/assigner/net/optimizer (:46-89), input readers (:93-120),
the step loop with flattened metric logging (:140-262), time-based +
per-eval checkpointing with resume from the persisted global step
(:263-327), and ``predict_kitti_to_anno`` result conversion (:437-508).

Here: ONE jitted train step (pillarize happens host-side at static
shape; forward+loss+backward+Adam in a single XLA program, donated
state), data-parallel over the device mesh, ``.npz`` checkpoints behind
the reference's checkpoints.json index contract.
"""

from __future__ import annotations

import functools
import os
import pathlib
import time

import jax
import numpy as np

from papc_tpu.detect import box_np
from papc_tpu.detect import builders
from papc_tpu.detect.config import cfg_from_list, cfg_from_yaml_file, save_config
from papc_tpu.detect.detector import compute_loss, predict
from papc_tpu.detect.kitti.preprocess import collate_batch
from papc_tpu.parallel.mesh import make_mesh_for_batch, replicate
from papc_tpu.train import checkpoint as ckpt_lib
from papc_tpu.train.trainer import TrainState


def flat_nested_json_dict(json_dict, sep=".") -> dict:
    """Flatten nested dicts for metric logging (reference :351-368)."""
    out = {}

    def _flat(d, prefix=""):
        for k, v in d.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, dict):
                _flat(v, key)
            else:
                out[key] = v

    _flat(json_dict)
    return out


def example_to_device_batch(example: dict) -> dict:
    """Select the tensors the jitted step consumes."""
    if "points" in example:  # device-pillarize path: ship raw clouds
        batch = {
            "points": example["points"].astype(np.float32),
            "points_mask": example["points_mask"].astype(bool),
            "anchors": example["anchors"].astype(np.float32),
        }
    else:
        batch = {
            "num_points": example["num_points"].astype(np.int32),
            "coordinates": example["coordinates"].astype(np.int32),
            "anchors": example["anchors"].astype(np.float32),
        }
        if "points_flat" in example:  # flat-PFN path (no padded grid)
            batch["points_flat"] = example["points_flat"].astype(
                np.float32
            )
            batch["point_pillar"] = example["point_pillar"].astype(
                np.int32
            )
        else:
            batch["voxels"] = example["voxels"].astype(np.float32)
    if "labels" in example:
        batch["labels"] = example["labels"].astype(np.int32)
        batch["reg_targets"] = example["reg_targets"].astype(np.float32)
    if "anchors_mask" in example:
        batch["anchors_mask"] = example["anchors_mask"].astype(bool)
    return batch


def make_pillarizer(voxel_generator, max_voxels: int):
    """Device-side pillarization (papc_tpu.ops.voxelize, vmapped) for
    batches that carry raw points instead of host-built pillars."""
    from papc_tpu.ops import voxelize

    vsize = tuple(float(v) for v in voxel_generator.voxel_size)
    prange = tuple(
        float(v) for v in voxel_generator.point_cloud_range
    )
    grid = tuple(int(g) for g in voxel_generator.grid_size)
    max_points = int(voxel_generator.max_num_points)

    def pillarize(batch):
        if "points" not in batch:
            return (
                batch["voxels"],
                batch["num_points"],
                batch["coordinates"],
            )
        out = jax.vmap(
            lambda p, m: voxelize(
                p, m, vsize, prange, grid, max_points, max_voxels
            )
        )(batch["points"], batch["points_mask"])
        return out.voxels, out.num_points, out.coords

    return pillarize


def make_detection_train_step(
    model, loss_cfg, pillarize=None, precision: str = "fp32"
):
    from papc_tpu.train.precision import cast_floating
    from papc_tpu.train.running_metrics import (
        AccuracyState,
        PrecisionRecallState,
    )

    bf16 = precision == "bf16"
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    import jax.numpy as jnp

    def loss_fn(params, batch_stats, batch):
        points = batch.get("points_flat")
        point_pillar = batch.get("point_pillar")
        if pillarize is not None:
            voxels, num_points, coords = pillarize(batch)
        else:
            voxels, num_points, coords = (
                batch.get("voxels"), batch["num_points"],
                batch["coordinates"],
            )
        if bf16:
            # bf16 forward/backward with fp32 master params; the loss
            # (focal CE + smooth-L1 on decoded offsets) runs fp32 on
            # fp32-cast head outputs — cheap next to the RPN convs
            params = cast_floating(params, jnp.bfloat16)
            if voxels is not None:
                voxels = voxels.astype(jnp.bfloat16)
            if points is not None:
                points = points.astype(jnp.bfloat16)
        preds, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats},
            voxels,
            num_points,
            coords,
            train=True,
            points=points,
            point_pillar=point_pillar,
            mutable=["batch_stats"],
        )
        if bf16:
            preds = cast_floating(preds, jnp.float32)
        loss, metrics = compute_loss(
            preds,
            batch["labels"],
            batch["reg_targets"],
            batch["anchors"],
            loss_cfg,
        )
        new_stats = cast_floating(mutated["batch_stats"], jnp.float32)
        return loss, (metrics, preds, new_stats)

    # donate params/opt-state: at KITTI scale the Adam moments alone are
    # ~10 MB and XLA can update them in place instead of allocating a
    # fresh copy every step. The running-metric states stay undonated —
    # their freshly-created scalar leaves can alias one constant buffer,
    # which trips XLA's donate-same-buffer-twice check.
    def step_impl(state: TrainState, batch: dict, rm: dict):
        (loss, (metrics, preds, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params, state.batch_stats, batch)
        state = state.apply_gradients(grads=grads)
        state = state.replace(batch_stats=new_stats)
        # running RPN metrics (reference update_metrics,
        # detectors/pointpillars.py:420-457)
        B = batch["labels"].shape[0]
        ncls = (
            loss_cfg.num_class
            if loss_cfg.encode_background_as_zeros
            else loss_cfg.num_class + 1
        )
        # [B, ncls, A] layout, as in detector.compute_loss
        from papc_tpu.detect.detector import _heads_to_ca

        cls_preds = _heads_to_ca(preds["cls_preds"], B, ncls)
        rm = {
            "acc": rm["acc"].update(
                batch["labels"], cls_preds, channel_axis=1
            ),
            "pr": rm["pr"].update(
                batch["labels"], cls_preds, channel_axis=1
            ),
        }
        metrics["rpn_acc"] = rm["acc"].value
        return state, metrics, rm

    train_step = functools.partial(jax.jit, donate_argnums=(0,))(
        step_impl
    )
    # the un-jitted update, for composition inside larger jitted
    # programs (make_scan_detection_train_step's lax.scan body)
    train_step.impl = step_impl

    def init_running_metrics():
        return {
            "acc": AccuracyState.create(),
            "pr": PrecisionRecallState.create(),
        }

    return train_step, init_running_metrics


def make_scan_detection_train_step(
    model, loss_cfg, pillarize=None, precision: str = "fp32"
):
    """K detection train steps scanned inside ONE jitted call.

    Same motivation as :func:`papc_tpu.train.trainer.make_scan_train_step`:
    each jitted call pays a host dispatch, so per-step stepping can
    leave the device idle between steps; scanning K steps per call runs
    them back-to-back on device. Takes a stacked batch pytree
    (leading axis K) and the running-metric carry; returns
    ``(state, stacked metrics [K], rm)``. The reference's loop
    (``pointpillars/train.py:140-262``) syncs every step.

    All K batches are resident in device memory for the call — at the KITTI
    workload (B=2, 12k pillars) each is ~38 MB, so keep K modest (4-16).
    """
    from jax import lax

    train_step, _ = make_detection_train_step(
        model, loss_cfg, pillarize, precision=precision
    )
    step_impl = train_step.impl

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scan_train_step(state: TrainState, stacked_batch: dict, rm: dict):
        def body(carry, batch):
            st, r = carry
            st, metrics, r = step_impl(st, batch, r)
            return (st, r), metrics

        (state, rm), metrics = lax.scan(
            body, (state, rm), stacked_batch
        )
        return state, metrics, rm

    return scan_train_step


def make_predict_step(
    model, predict_cfg, box_coder, pillarize=None,
    precision: str = "fp32",
):
    """``precision="bf16"`` runs the network forward in bf16 (params +
    point inputs cast at apply time; decode/NMS stay f32 on f32-cast
    head maps) — the serving mode for the HBM-bound RPN forward."""
    from papc_tpu.train.precision import cast_floating

    bf16 = precision == "bf16"
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    import jax.numpy as jnp

    def _apply(state: TrainState, batch: dict):
        points = batch.get("points_flat")
        if pillarize is not None:
            voxels, num_points, coords = pillarize(batch)
        else:
            voxels, num_points, coords = (
                batch.get("voxels"), batch["num_points"],
                batch["coordinates"],
            )
        params = state.params
        if bf16:
            params = cast_floating(params, jnp.bfloat16)
            if voxels is not None:
                voxels = voxels.astype(jnp.bfloat16)
            if points is not None:
                points = points.astype(jnp.bfloat16)
        preds = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            voxels,
            num_points,
            coords,
            train=False,
            points=points,
            point_pillar=batch.get("point_pillar"),
        )
        if bf16:
            preds = cast_floating(preds, jnp.float32)
        return preds

    if predict_cfg.multiclass_nms:
        # reference's multiclass branch (detectors/pointpillars.py:279-316,
        # selected by yaml PREDICT.multiclass_nms): network + decode run
        # jitted on device, the ragged per-class NMS runs on host via the
        # native C++ kernels, padded back to the static [B, post] layout
        from papc_tpu.detect.detector import decode_raw, predict_multiclass

        @jax.jit
        def raw_step(state: TrainState, batch: dict):
            preds = _apply(state, batch)
            return decode_raw(
                preds, batch["anchors"], box_coder.decode_jnp, predict_cfg
            )

        def predict_step(state: TrainState, batch: dict):
            boxes, scores, dirs = raw_step(state, batch)
            return predict_multiclass(
                boxes, scores, dirs, predict_cfg,
                anchors_mask=batch.get("anchors_mask"),
            )

        return predict_step

    @jax.jit
    def predict_step(state: TrainState, batch: dict):
        preds = _apply(state, batch)
        return predict(
            preds,
            batch["anchors"],
            box_coder.decode_jnp,
            predict_cfg,
            anchors_mask=batch.get("anchors_mask"),
        )

    return predict_step


def predictions_to_kitti_annos(
    dets: dict,
    examples: dict,
    class_names,
    center_limit_range=None,
):
    """Convert fixed-size device detections into KITTI anno dicts
    (reference ``predict_kitti_to_anno`` :437-508)."""
    from papc_tpu.detect.kitti import common as kitti

    annos = []
    B = dets["box3d_lidar"].shape[0]
    for i in range(B):
        valid = np.asarray(dets["valid"][i])
        boxes_lidar = np.asarray(dets["box3d_lidar"][i])[valid]
        scores = np.asarray(dets["scores"][i])[valid]
        labels = np.asarray(dets["label_preds"][i])[valid]
        rect = np.asarray(examples["rect"][i])
        Trv2c = np.asarray(examples["Trv2c"][i])
        P2 = np.asarray(examples["P2"][i])
        img_shape = np.asarray(examples["image_shape"][i])
        image_idx = int(np.asarray(examples["image_idx"][i]))

        if center_limit_range is not None and len(boxes_lidar):
            lim = np.asarray(center_limit_range)
            keep = ~(
                np.any(boxes_lidar[:, :3] < lim[:3], axis=1)
                | np.any(boxes_lidar[:, :3] > lim[3:], axis=1)
            )
            boxes_lidar = boxes_lidar[keep]
            scores = scores[keep]
            labels = labels[keep]

        if len(boxes_lidar) == 0:
            anno = kitti.empty_result_anno()
            anno["image_idx"] = np.array([], dtype=np.int64)
            annos.append(anno)
            continue

        box_cam = box_np.box_lidar_to_camera(boxes_lidar, rect, Trv2c)
        bbox = box_np.box3d_to_bbox(box_cam, rect, Trv2c, P2)
        # clip to the image
        bbox[:, [0, 2]] = np.clip(bbox[:, [0, 2]], 0, img_shape[1])
        bbox[:, [1, 3]] = np.clip(bbox[:, [1, 3]], 0, img_shape[0])

        anno = kitti.get_start_result_anno()
        for j in range(len(boxes_lidar)):
            anno["name"].append(class_names[int(labels[j])])
            anno["truncated"].append(0.0)
            anno["occluded"].append(0)
            anno["alpha"].append(
                -np.arctan2(-boxes_lidar[j, 1], boxes_lidar[j, 0])
                + box_cam[j, 6]
            )
            anno["bbox"].append(bbox[j])
            anno["dimensions"].append(box_cam[j, 3:6])
            anno["location"].append(box_cam[j, :3])
            anno["rotation_y"].append(box_cam[j, 6])
            anno["score"].append(scores[j])
        anno = {k: np.stack(v) for k, v in anno.items()}
        anno["image_idx"] = np.full(
            len(boxes_lidar), image_idx, dtype=np.int64
        )
        annos.append(anno)
    return annos


def _iter_batches(
    dataset, batch_size, shuffle, rng,
    pool=None, epoch=0, max_batches=None,
):
    """Batch iterator; with a :class:`papc_tpu.data.workers.SamplePool`
    samples are prepared in spawn-based worker processes (reference
    DataLoader NUM_WORKERS parity). ``max_batches`` bounds the epoch so
    the generator (and any pool work) completes exactly when the
    training loop stops consuming — no abandoned in-flight tasks."""
    n = len(dataset)
    dataset.set_epoch(epoch)  # single epoch channel for both modes
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    usable = n - n % batch_size
    n_batches = usable // batch_size
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    order = order[: n_batches * batch_size]
    if pool is not None and len(order):
        buf = []
        for ex in pool.imap(epoch, order):
            buf.append(ex)
            if len(buf) == batch_size:
                yield collate_batch(buf)
                buf = []
        return
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        yield collate_batch([dataset[int(i)] for i in idx])


def train(
    cfg_file: str | None = None,
    model_dir: str = "./ppmodel",
    result_path: str | None = None,
    cfg_overrides: list | None = None,
    max_steps: int | None = None,
    display_step: int = 50,
    eval_on_finish: bool = True,
    seed: int = 0,
    log=print,
):
    """Train PointPillars from a YAML experiment config."""
    from papc_tpu.detect.config import DEFAULT_CONFIG_PATH
    from papc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    cfg = cfg_from_yaml_file(cfg_file or DEFAULT_CONFIG_PATH)
    if cfg_overrides:
        cfg_from_list(cfg, cfg_overrides)
    os.makedirs(model_dir, exist_ok=True)
    save_config(cfg, os.path.join(model_dir, "pipeline.config"))
    rng_np = np.random.RandomState(seed)

    voxel_generator = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    box_coder = builders.build_box_coder(cfg.BOX_CODER)
    target_assigner = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, box_coder
    )
    model = builders.build_network(cfg, voxel_generator, target_assigner)
    loss_cfg = builders.build_loss_config(cfg, target_assigner)
    predict_cfg = builders.build_predict_config(cfg, target_assigner)

    train_ds = builders.build_dataset(
        cfg, cfg.TRAIN_INPUT_READER, voxel_generator, target_assigner,
        training=True, rng=rng_np, log=log,
    )
    eval_ds = builders.build_dataset(
        cfg, cfg.EVAL_INPUT_READER, voxel_generator, target_assigner,
        training=False, log=log,
    )

    batch_size = int(cfg.TRAIN_INPUT_READER.BATCH_SIZE)
    total_steps = int(max_steps or cfg.TRAIN_CONFIG.STEPS)
    save_secs = int(cfg.TRAIN_CONFIG.get("SAVE_CHECKPOINTS_SECS", 1800))
    steps_per_eval = int(cfg.TRAIN_CONFIG.get("STEPS_PER_EVAL", 0))

    # init from one real example
    mesh = make_mesh_for_batch(batch_size)
    example0 = collate_batch([train_ds[0]])
    batch0 = example_to_device_batch(example0)
    pillarize = (
        make_pillarizer(
            voxel_generator, int(cfg.VOXEL_GENERATOR.MAX_VOXELS)
        )
        if "points" in batch0
        else None
    )
    v0, n0, c0 = (
        pillarize(batch0)
        if pillarize is not None
        else (batch0.get("voxels"), batch0["num_points"],
              batch0["coordinates"])
    )
    rng = jax.random.PRNGKey(seed)
    variables = model.init(
        rng, v0, n0, c0, train=False,
        points=batch0.get("points_flat"),
        point_pillar=batch0.get("point_pillar"),
    )
    tx = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER)
    state = TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=tx,
    )
    # resume
    target = {
        "params": state.params,
        "opt_state": state.opt_state,
        "batch_stats": state.batch_stats,
        "step": state.step,
    }
    restored = ckpt_lib.try_restore_latest(model_dir, "pointpillars", target)
    if restored is not None:
        state = state.replace(
            params=restored["params"],
            opt_state=restored["opt_state"],
            batch_stats=restored["batch_stats"],
            step=restored["step"],
        )
        log(f"resumed from step {int(state.step)}")
    state = replicate(mesh, state)

    precision = str(cfg.TRAIN_CONFIG.get("PRECISION", "fp32"))
    train_step, init_rm = make_detection_train_step(
        model, loss_cfg, pillarize, precision=precision
    )
    # SCAN_STEPS > 1: run K steps per jitted call (lax.scan) — amortizes
    # host dispatch and keeps the device busy back-to-back
    scan_steps = int(cfg.TRAIN_CONFIG.get("SCAN_STEPS", 0) or 0)
    scan_step_fn = (
        make_scan_detection_train_step(
            model, loss_cfg, pillarize, precision=precision
        )
        if scan_steps > 1
        else None
    )
    running = init_rm()
    predict_step = make_predict_step(
        model, predict_cfg, box_coder, pillarize
    )

    step = int(state.step)
    last_save = time.time()
    # step timing: sync (force a value fetch) exactly on display steps,
    # attribute the window to the steps inside it
    from papc_tpu.utils.profiling import StepTimer

    step_timer = StepTimer()
    from papc_tpu.data.prefetch import prefetch_to_device
    from papc_tpu.parallel.mesh import data_sharding, stacked_data_sharding

    def _tagged(examples):
        """Host-side grouping for the scanned path: K device-batch dicts
        stacked into one [K, ...] pytree; leftovers single-step."""
        if scan_step_fn is None:
            for ex in examples:
                yield ("single", example_to_device_batch(ex))
            return
        buf = []
        for ex in examples:
            buf.append(example_to_device_batch(ex))
            if len(buf) == scan_steps:
                yield (
                    "scan",
                    jax.tree_util.tree_map(
                        lambda *xs: np.stack(xs), *buf
                    ),
                )
                buf = []
        for b in buf:
            yield ("single", b)

    num_workers = int(cfg.TRAIN_INPUT_READER.get("NUM_WORKERS", 0))
    pool = None
    if num_workers > 0:
        from papc_tpu.data.workers import SamplePool

        # worker mode: per-item sampler reseeding keeps DB-paste
        # augmentation deterministic for any worker count
        train_ds.enable_per_item_sampler_seeding(True)
        pool = SamplePool(train_ds, num_workers)
    epoch_counter = 0
    try:
        while step < total_steps:
            epoch_counter += 1
            for kind, batch in prefetch_to_device(
                _tagged(_iter_batches(
                    train_ds, batch_size, True, rng_np,
                    pool=pool, epoch=epoch_counter,
                    max_batches=total_steps - step,
                )),
                size=2,
                sharding=lambda kb: (
                    stacked_data_sharding(mesh)
                    if kb[0] == "scan"
                    else data_sharding(mesh)
                ),
            ):
                step_timer.start()
                if kind == "scan":
                    state, mk, running = scan_step_fn(
                        state, batch, running
                    )
                    metrics = jax.tree_util.tree_map(
                        lambda x: x[-1], mk
                    )
                    n_done = scan_steps
                else:
                    state, metrics, running = train_step(
                        state, batch, running
                    )
                    n_done = 1
                step += n_done
                display = step % display_step < n_done
                steptime = step_timer.stop(
                    metrics["loss"], sync=display, steps=n_done
                )
                if display:
                    m = {
                        k: round(float(v), 5)
                        for k, v in metrics.items()
                    }
                    m["rpn_prec@0.5"] = round(
                        float(running["pr"].precision[2]), 4
                    )
                    m["rpn_rec@0.5"] = round(
                        float(running["pr"].recall[2]), 4
                    )
                    m["step"] = step
                    m["steptime"] = round(steptime, 4)
                    line = ", ".join(f"{k}={v}" for k, v in
                                     flat_nested_json_dict(m).items())
                    log(line)
                    with open(
                        os.path.join(model_dir, "log.txt"), "a"
                    ) as f:
                        f.write(line + "\n")
                if time.time() - last_save > save_secs:
                    _save(state, model_dir, step)
                    last_save = time.time()
                    step_timer.discard()
                if steps_per_eval and step % steps_per_eval < n_done:
                    # periodic eval + snapshot (the reference's eval loop
                    # is commented out wholesale — train.py:278-322)
                    _save(state, model_dir, step)
                    annos = evaluate(
                        model, state, predict_step, eval_ds, cfg,
                        predict_cfg, log=log,
                    )
                    gt_annos = [
                        info["annos"]
                        for info in eval_ds.kitti_infos
                        if "annos" in info
                    ]
                    if len(gt_annos) == len(annos):
                        from papc_tpu.eval.kitti_eval import (
                            get_official_eval_result,
                        )

                        log(get_official_eval_result(
                            gt_annos, annos,
                            list(cfg.EVAL_INPUT_READER.CLASS_NAMES),
                        ))
                    step_timer.discard()
                if step >= total_steps:
                    break
    except Exception:
        # Save-on-crash (reference train.py:325-327). The train step
        # donates the state's buffers, so if the crash happened INSIDE a
        # step the current `state` may reference deleted arrays — fall
        # back to the last periodic checkpoint already on disk instead of
        # masking the original exception with a buffer-deleted error.
        try:
            _save(state, model_dir, step)
        except Exception as save_err:  # noqa: BLE001
            log(
                "crash-save skipped (state donated to the failing step): "
                f"{save_err!r}; latest periodic checkpoint stands"
            )
        raise
    finally:
        if pool is not None:
            pool.close()
    _save(state, model_dir, step)

    if eval_on_finish:
        annos = evaluate(
            model, state, predict_step, eval_ds, cfg, predict_cfg, log=log
        )
        if result_path:
            os.makedirs(result_path, exist_ok=True)
            _write_result_files(annos, result_path)
        return state, annos
    return state, None


def _save(state, model_dir, step):
    ckpt_lib.save(
        model_dir,
        "pointpillars",
        {
            "params": state.params,
            "opt_state": state.opt_state,
            "batch_stats": state.batch_stats,
            "step": state.step,
        },
        step,
    )


def evaluate(
    model, state, predict_step, eval_ds, cfg, predict_cfg, log=print
):
    """Run prediction over the eval set → list of KITTI annos."""
    class_names = list(cfg.EVAL_INPUT_READER.CLASS_NAMES)
    limit = cfg.MODEL.POST_PROCESSING.get("post_center_limit_range")
    batch_size = int(cfg.EVAL_INPUT_READER.BATCH_SIZE)
    annos = []
    n = len(eval_ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        # pad final batch by repeating the last sample (static shapes)
        pad = batch_size - len(idx)
        idx = idx + [idx[-1]] * pad
        example = collate_batch([eval_ds[int(i)] for i in idx])
        batch = example_to_device_batch(example)
        dets = predict_step(state, batch)
        batch_annos = predictions_to_kitti_annos(
            dets, example, class_names, limit
        )
        annos.extend(batch_annos[: len(batch_annos) - pad or None])
    log(f"evaluated {len(annos)} frames")
    return annos


def _write_result_files(annos, result_path):
    from papc_tpu.detect.kitti import common as kitti

    for anno in annos:
        idx = int(anno["image_idx"][0]) if len(anno["image_idx"]) else 0
        lines = []
        for j in range(len(anno["name"])):
            lines.append(
                kitti.kitti_result_line(
                    {
                        "name": anno["name"][j],
                        "alpha": anno["alpha"][j],
                        "bbox": anno["bbox"][j],
                        # result files use h,w,l order
                        "dimensions": anno["dimensions"][j][[1, 2, 0]],
                        "location": anno["location"][j],
                        "rotation_y": anno["rotation_y"][j],
                        "score": anno["score"][j],
                    }
                )
            )
        path = pathlib.Path(result_path) / (
            kitti.get_image_index_str(idx) + ".txt"
        )
        path.write_text("\n".join(lines) + ("\n" if lines else ""))


def evaluate_checkpoint(
    cfg_file: str | None = None,
    model_dir: str = "./ppmodel",
    result_path: str | None = None,
    cfg_overrides: list | None = None,
    with_map: bool = True,
    log=print,
):
    """Evaluate the latest checkpoint: predictions → KITTI annos →
    official mAP (the reference's commented-out eval loop,
    ``train.py:278-322``, as a working entry point)."""
    from papc_tpu.detect.config import DEFAULT_CONFIG_PATH
    from papc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    cfg = cfg_from_yaml_file(cfg_file or DEFAULT_CONFIG_PATH)
    if cfg_overrides:
        cfg_from_list(cfg, cfg_overrides)
    voxel_generator = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    box_coder = builders.build_box_coder(cfg.BOX_CODER)
    target_assigner = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, box_coder
    )
    model = builders.build_network(cfg, voxel_generator, target_assigner)
    predict_cfg = builders.build_predict_config(cfg, target_assigner)
    eval_ds = builders.build_dataset(
        cfg, cfg.EVAL_INPUT_READER, voxel_generator, target_assigner,
        training=False, log=log,
    )

    example0 = collate_batch([eval_ds[0]])
    batch0 = example_to_device_batch(example0)
    pillarize = (
        make_pillarizer(
            voxel_generator, int(cfg.VOXEL_GENERATOR.MAX_VOXELS)
        )
        if "points" in batch0
        else None
    )
    v0, n0, c0 = (
        pillarize(batch0)
        if pillarize is not None
        else (batch0.get("voxels"), batch0["num_points"],
              batch0["coordinates"])
    )
    rng = jax.random.PRNGKey(0)
    variables = model.init(
        rng, v0, n0, c0, train=False,
        points=batch0.get("points_flat"),
        point_pillar=batch0.get("point_pillar"),
    )
    tx = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER)
    state = TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=tx,
    )
    target = {
        "params": state.params,
        "opt_state": state.opt_state,
        "batch_stats": state.batch_stats,
        "step": state.step,
    }
    restored = ckpt_lib.try_restore_latest(model_dir, "pointpillars", target)
    if restored is None:
        raise SystemExit(f"no checkpoint found in {model_dir}")
    state = state.replace(
        params=restored["params"],
        batch_stats=restored["batch_stats"],
        step=restored["step"],
    )
    log(f"evaluating checkpoint at step {int(state.step)}")
    predict_step = make_predict_step(
        model, predict_cfg, box_coder, pillarize
    )
    annos = evaluate(
        model, state, predict_step, eval_ds, cfg, predict_cfg, log=log
    )
    if result_path:
        os.makedirs(result_path, exist_ok=True)
        _write_result_files(annos, result_path)
    if with_map:
        from papc_tpu.eval.kitti_eval import get_official_eval_result

        gt_annos = [
            info["annos"]
            for info in eval_ds.kitti_infos
            if "annos" in info
        ]
        if len(gt_annos) == len(annos):
            result = get_official_eval_result(
                gt_annos, annos,
                list(cfg.EVAL_INPUT_READER.CLASS_NAMES),
            )
            log(result)
            return annos, result
    return annos, None


def main():
    import argparse

    parser = argparse.ArgumentParser(description="PointPillars training")
    parser.add_argument("command", choices=["train", "evaluate"],
                        nargs="?", default="train")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--model_dir", default="./ppmodel")
    parser.add_argument("--result_path", default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--display_step", type=int, default=50)
    parser.add_argument(
        "--set", dest="set_cfgs", nargs="*", default=None,
        help="dotted config overrides: KEY VALUE [KEY VALUE ...]",
    )
    args = parser.parse_args()
    if args.command == "evaluate":
        evaluate_checkpoint(
            cfg_file=args.cfg_file,
            model_dir=args.model_dir,
            result_path=args.result_path,
            cfg_overrides=args.set_cfgs,
        )
    else:
        train(
            cfg_file=args.cfg_file,
            model_dir=args.model_dir,
            result_path=args.result_path,
            cfg_overrides=args.set_cfgs,
            max_steps=args.max_steps,
            display_step=args.display_step,
        )


if __name__ == "__main__":
    main()
