"""Detection learning-to-mAP proof (VERDICT r1 #2a): train PointPillars
on synthetic KITTI until the OFFICIAL mAP clears a floor — a test that
fails if the loss/target/NMS/eval chain is subtly wrong, not just if it
crashes (the r1 synthetic yaw-convention bug, invisible to every other
test, capped this exact metric at ~20).

Slow: ~12 min on CPU — gated behind RUN_SLOW=1. Recorded runs of the
same recipe (docs/LEARNING.md): bev/3d AP@0.5 ≈ 79/76 at 800 steps on 72
held-out GT boxes, rising to ~86/86 by 4000 steps (CPU: 89/89).

The val set must carry >= 41 valid GT boxes: the official 41-recall-point
AP arithmetic (`get_thresholds` + `get_mAP`) structurally caps AP at
~ceil(num_gt*40/num_gt... — concretely, 24 GT can fill at most ~22
threshold slots, zeroing 5 of the 11 mAP samples and capping AP at ~54
no matter how good the detector is.
"""

import os
import pathlib
import pickle

import numpy as np
import pytest
import yaml

pytestmark = pytest.mark.skipif(
    not os.environ.get("RUN_SLOW"),
    reason="slow (~12 min): set RUN_SLOW=1 to run; recorded runs in "
    "docs/LEARNING.md",
)

STEPS = 800
# recorded at 800 steps: bev/3d = 79/76 (earlier build), CPU = 77/68. Floors sit well
# below the healthy range but far above the ~20 plateau a systematic
# defect produces (see docs/LEARNING.md)
BEV_FLOOR = 65.0
D3_FLOOR = 55.0


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    from papc_tpu.data.synthetic_kitti import write_kitti
    from papc_tpu.detect.kitti.create_data import (
        create_groundtruth_database,
        create_kitti_info_file,
        create_reduced_point_cloud,
    )

    root = str(tmp_path_factory.mktemp("kitti_learning"))
    write_kitti(
        root,
        n_train=32,
        n_val=16,  # 48 GT >= the 41 recall slots of the official AP
        num_cars=3,
        x_range=(6.0, 22.0),
        y_range=(-10.0, 10.0),
        car_points=(150, 300),
    )
    create_kitti_info_file(
        root, imageset_dir=str(pathlib.Path(root) / "ImageSets")
    )
    create_reduced_point_cloud(root)
    create_groundtruth_database(root, used_classes=["Car"])
    return root


@pytest.fixture(scope="module")
def learn_cfg(kitti_root, tmp_path_factory):
    """The default config at a 25.6x25.6 m / 0.32 m grid with a narrow
    RPN — same code path, CPU-feasible compute."""
    from papc_tpu.detect.config import DEFAULT_CONFIG_PATH

    cfg = yaml.safe_load(open(DEFAULT_CONFIG_PATH))
    cfg["VOXEL_GENERATOR"]["POINT_CLOUD_RANGE"] = [0, -12.8, -3, 25.6, 12.8, 1]
    cfg["VOXEL_GENERATOR"]["VOXEL_SIZE"] = [0.32, 0.32, 4]
    cfg["VOXEL_GENERATOR"]["MAX_VOXELS"] = 3000
    cfg["VOXEL_GENERATOR"]["MAX_NUMBER_OF_POINTS_PER_VOXEL"] = 50
    cfg["MODEL"]["PILLAR_FEATURE_EXTRACTOR"]["num_filters"] = [32]
    cfg["MODEL"]["BACKBONE"]["num_filters"] = [32, 64, 64]
    cfg["MODEL"]["BACKBONE"]["num_upsample_filters"] = [32, 32, 32]
    cfg["MODEL"]["LOSS"]["localization_loss"]["weighted_smooth_l1"][
        "code_weight"
    ] = [1, 1, 1, 1, 1, 1, 2]
    gen = cfg["TARGET_ASSIGNER"]["ANCHOR_GENERATORS"][0][
        "anchor_generator_stride"
    ]
    gen["strides"] = [0.64, 0.64, 0.0]
    gen["offsets"] = [0.32, -12.48, -1.78]
    gen["matched_threshold"] = 0.5
    gen["unmatched_threshold"] = 0.35
    cfg["MODEL"]["POST_PROCESSING"]["nms_pre_max_size"] = 256
    cfg["MODEL"]["POST_PROCESSING"]["nms_post_max_size"] = 16
    cfg["MODEL"]["POST_PROCESSING"]["nms_score_threshold"] = 0.05
    for reader in ("TRAIN_INPUT_READER", "EVAL_INPUT_READER"):
        cfg[reader]["MAX_NUMBER_OF_VOXELS"] = 3000
        cfg[reader]["KITTI_ROOT_PATH"] = kitti_root
        cfg[reader]["BATCH_SIZE"] = 4
    opt = cfg["TRAIN_CONFIG"]["OPTIMIZER"]["learning_rate"]
    opt["initial_learning_rate"] = 0.003
    opt["decay_steps"] = 10**7  # constant LR at this scale
    path = tmp_path_factory.mktemp("cfg") / "learn.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_pointpillars_reaches_map_floor(kitti_root, learn_cfg, tmp_path):
    from papc_tpu.detect.train import train
    from papc_tpu.eval.kitti_eval import get_official_eval_result

    state, annos = train(
        cfg_file=learn_cfg,
        model_dir=str(tmp_path / "model"),
        max_steps=STEPS,
        display_step=10**6,
        eval_on_finish=True,
        log=lambda s: None,
    )
    with open(pathlib.Path(kitti_root) / "kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    gt_annos = [info["annos"] for info in infos]
    result, data = get_official_eval_result(
        gt_annos, annos, ["Car"], return_data=True
    )
    bev_moderate = float(data[(0, "0.5")]["bev"][1])
    d3_moderate = float(data[(0, "0.5")]["3d"][1])
    assert bev_moderate >= BEV_FLOOR, f"\n{result}"
    assert d3_moderate >= D3_FLOOR, f"\n{result}"
