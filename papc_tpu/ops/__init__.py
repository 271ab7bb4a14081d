"""papc_tpu.ops — functional kernel library (pure jnp implementations,
plus a Pallas-Triton FPS kernel on CUDA, behind one API). All static-shape, all batched, fully
on-device."""

from papc_tpu.ops.geometry import index_points, pc_normalize, square_distance
from papc_tpu.ops.grouping import (
    knn,
    query_ball_point,
    query_ball_point_tiled,
    sample_and_group,
    sample_and_group_all,
)
from papc_tpu.ops.interpolate import three_nn_interpolate
from papc_tpu.ops.iou import box5_to_corners, iou_2d, rotate_iou
from papc_tpu.ops.nms import greedy_suppress, nms, rotate_nms
from papc_tpu.ops.sampling import farthest_point_sample
from papc_tpu.ops.voxelize import (
    VoxelizedPoints,
    scatter_to_bev,
    scatter_to_bev_batched,
    voxelize,
)

__all__ = [
    "square_distance",
    "index_points",
    "pc_normalize",
    "farthest_point_sample",
    "query_ball_point",
    "query_ball_point_tiled",
    "knn",
    "sample_and_group",
    "sample_and_group_all",
    "three_nn_interpolate",
    "voxelize",
    "scatter_to_bev",
    "scatter_to_bev_batched",
    "VoxelizedPoints",
    "iou_2d",
    "rotate_iou",
    "box5_to_corners",
    "nms",
    "rotate_nms",
    "greedy_suppress",
]
