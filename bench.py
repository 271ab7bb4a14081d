"""Benchmark harness — prints ONE JSON line for the driver.

Primary metric (per BASELINE.md): ShapeNet classification training
throughput in points/sec/chip on the flagship PointNet++ SSG model at the
reference's default scale (batch 32, 1024 points, 16 classes — reference
root ``train.py:5-16``). ``extra`` carries the other BASELINE.md metrics:
PointNet++ SSG epoch time (synthetic ShapeNet-sized epoch) and pillarize
ms/frame (full-KITTI-scale cloud through the native voxelizer).

Measurement discipline: every DEVICE number comes from
``papc_tpu.utils.timing.fetch_forced_time`` — K chained steps, a forced
value fetch, per-step time from the K-slope. Device rows carry an
``mfu`` against the card's published peak
(:data:`papc_tpu.utils.timing.PEAK_FLOPS`: fp32 rows at the default
matmul precision against the TF32 peak, bf16 rows against the bf16 peak),
and :func:`papc_tpu.utils.timing.check_physical` REFUSES to print any
number above that peak. Host rows (pillarize, cc kernels) are plain
wall-clock over host calls. The JSON names the card (``nvidia-smi``
name and power limit) and the matmul precision of every row.

It runs on an NVIDIA GPU only: on another platform it exits non-zero.
A stage that fails is reported under ``failed_stages`` and makes the
exit code non-zero.

Baseline: the reference publishes no numbers and cannot run here
(Paddle+CUDA). BASELINE.md documents a ~65k points/sec lower-bound
estimate for the CUDA-Paddle reference: its FPS alone serializes
npoint host↔device round-trips per SA layer (640 per forward at these
sizes — ``pointnet2_basic_layers.py:65-95``), bounding a train step near
~0.5 s. ``vs_baseline`` is measured-points-per-sec / 65536.
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_POINTS_PER_SEC = 65536.0  # documented estimate, see docstring
B, N = 32, 1024
SHAPENET_TRAIN_SAMPLES = 12137  # 6 train shards of the ShapeNet h5 set


def ssg_analytic_train_flops(b=B):
    """Analytic model FLOPs of one SSG train step.

    XLA's ``cost_analysis`` also counts implementation work (the
    ``[B, S, N]`` distance matrices, gathers), so this derives the
    model FLOPs from the architecture
    (``models/classify/pointnet2.py``: SA(512,32,[64,64,128]) →
    SA(128,64,[128,128,256]) → SA(group_all,[256,512,1024]) → head),
    counting 2·MAC for every matmul, forward; the train step is
    fwd + bwd ≈ 3× (dW and dx contractions). Geometry side terms
    (square_distance, FPS updates, one-hot scatter contractions) are
    implementation work, not model FLOPs, and are excluded — MFU here
    is "useful model FLOPs / chip peak", the standard convention.
    """
    sa1 = b * 512 * 32 * 2 * (3 * 64 + 64 * 64 + 64 * 128)
    sa2 = b * 128 * 64 * 2 * (131 * 128 + 128 * 128 + 128 * 256)
    sa3 = b * 128 * 2 * (259 * 256 + 256 * 512 + 512 * 1024)
    head = b * 2 * (1024 * 512 + 512 * 256 + 256 * 16)
    return 3.0 * (sa1 + sa2 + sa3 + head)


def _peak_precision(precision: str) -> str:
    """Peak-table key for a row's compute precision: fp32 rows run at the
    default matmul precision, which is TF32 on the tensor cores."""
    return "bf16" if precision == "bf16" else "tf32"


def _device_time(step, *, ks=(10, 40), repeats=3, flops=None, label="",
                 precision="fp32"):
    """Fetch-forced K-slope per-step seconds + MFU, physics-checked.

    Returns ``(seconds, mfu_or_None)``; raises if the implied FLOP rate
    exceeds the card's peak (a broken timer must never enter the record).
    """
    from papc_tpu.utils.timing import check_physical, fetch_forced_time

    res = fetch_forced_time(
        step, k_small=ks[0], k_large=ks[1], repeats=repeats
    )
    mfu = (
        check_physical(res.step_s, flops, label, _peak_precision(precision))
        if flops else None
    )
    return res.step_s, mfu


def bench_train_step(precision="fp32"):
    import jax
    import jax.numpy as jnp

    from papc_tpu.models import init_model
    from papc_tpu.train.trainer import create_train_state, make_train_step
    from papc_tpu.utils.timing import compiled_flops

    spec = init_model("pointnet2_ssg", "clas", num_classes=16)
    rs = np.random.RandomState(0)
    batch = {
        "points": jnp.asarray(rs.randn(B, N, 3), jnp.float32),
        "label": jnp.asarray(rs.randint(0, 16, size=(B,))),
        "mask": jnp.ones((B,), bool),
    }
    rng = jax.random.PRNGKey(0)
    state = create_train_state(spec, rng, batch)
    train_step, _ = make_train_step(spec, precision=precision)

    holder = {"state": state}

    def step():
        s, loss, _ = train_step(holder["state"], batch, rng)
        holder["state"] = s
        return loss

    # analytic model FLOPs for MFU; XLA's count (kept as *_xla_counted)
    # includes implementation work
    flops = ssg_analytic_train_flops()
    flops_xla = compiled_flops(train_step, holder["state"], batch, rng)
    return _device_time(
        step, flops=flops, label=f"ssg_train_{precision}",
        precision=precision,
    ) + (flops, flops_xla)


def bench_train_step_scanned(precision="fp32", k_small=8, k_large=32):
    """Device-true SSG step time: K train steps scanned inside ONE jit
    (``make_scan_train_step`` — the production ``train(scan_steps=K)``
    path), per-step from the (k_large - k_small) slope of whole-call
    times. Unlike per-call stepping this excludes the per-call host
    dispatch, which is not device work and disappears in scanned
    training.
    """
    import jax
    import jax.numpy as jnp

    from papc_tpu.models import init_model
    from papc_tpu.train.trainer import (
        create_train_state,
        make_scan_train_step,
    )
    from papc_tpu.utils.timing import (
        check_physical,
        fetch_forced_time,
        scan_slope,
    )

    spec = init_model("pointnet2_ssg", "clas", num_classes=16)
    rs = np.random.RandomState(0)
    batch = {
        "points": jnp.asarray(rs.randn(B, N, 3), jnp.float32),
        "label": jnp.asarray(rs.randint(0, 16, size=(B,))),
        "mask": jnp.ones((B,), bool),
    }
    rng = jax.random.PRNGKey(0)
    state = create_train_state(spec, rng, batch)

    def whole_call_time(k):
        scan_step = make_scan_train_step(spec, k, precision=precision)
        stacked = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (k,) + x.shape), batch
        )
        # fresh copy per window: the scanned step DONATES the state, so
        # reusing the original buffers for the second K would fail
        holder = {"s": jax.tree_util.tree_map(jnp.copy, state)}

        def call():
            holder["s"], losses, _ = scan_step(
                holder["s"], stacked, rng
            )
            return losses

        res = fetch_forced_time(call, k_small=2, k_large=5, repeats=3)
        return res.step_s

    res = scan_slope(whole_call_time, k_small, k_large)
    flops = ssg_analytic_train_flops()
    mfu = check_physical(res.step_s, flops, f"ssg_scan_{precision}",
                         _peak_precision(precision))
    return res.step_s, mfu, flops


def _kitti_cloud(n=120000):
    rs = np.random.RandomState(0)
    return np.stack(
        [
            rs.uniform(0, 69.12, n),
            rs.uniform(-39.68, 39.68, n),
            rs.uniform(-3, 1, n),
            rs.rand(n),
        ],
        axis=1,
    ).astype(np.float32)


PILLARIZE_ARGS = (
    [0.16, 0.16, 4.0], [0, -39.68, -3, 69.12, 39.68, 1], 100, 12000
)


def bench_pillarize():
    """Full-KITTI-scale cloud → static padded pillars, host native
    voxelizer — the exact production feed of the train pipeline
    (reference numba claim: ~4.2 ms kernel-only,
    ``point_cloud_ops.py:113-115``). Returns (production_s, kernel_s):
    production includes the caller-owned padded output allocation; kernel
    is the amortized in-place path. HOST wall-clock (sound: no device)."""
    pts = _kitti_cloud()
    from papc_tpu import cc
    from papc_tpu.detect.voxelize_np import points_to_voxel

    points_to_voxel(pts, *PILLARIZE_ARGS, pad_output=True)  # warmup
    reps = 30
    t0 = time.perf_counter()
    for _ in range(reps):
        points_to_voxel(pts, *PILLARIZE_ARGS, pad_output=True)
    production = (time.perf_counter() - t0) / reps
    cc.points_to_voxel(pts, *PILLARIZE_ARGS)
    t0 = time.perf_counter()
    for _ in range(reps):
        cc.points_to_voxel(pts, *PILLARIZE_ARGS)
    kernel = (time.perf_counter() - t0) / reps
    return production, kernel


def bench_device_pillarize():
    """Device-side pillarization (papc_tpu.ops.voxelize, the
    make_pillarizer path): one full-scale frame, jitted on the GPU."""
    import jax
    import jax.numpy as jnp

    from papc_tpu.ops import voxelize

    pts = _kitti_cloud(25000)  # MAX_POINTS_PER_FRAME production cap
    vsize, prange, max_points, max_voxels = PILLARIZE_ARGS
    grid = (432, 496, 1)

    @jax.jit
    def pillarize(p, m):
        out = voxelize(
            p, m, tuple(vsize), tuple(prange), grid, max_points,
            max_voxels,
        )
        # chain: zero-valued perturbation keeps successive calls data-
        # dependent (un-chained identical dispatches mis-report)
        return out.voxels, p + (out.num_points.sum() * 0).astype(p.dtype)

    holder = {"p": jnp.asarray(pts)}
    mj = jnp.ones((len(pts),), bool)

    def step():
        v, holder["p"] = pillarize(holder["p"], mj)
        return v

    return _device_time(step, ks=(5, 20))[0]


def _pointpillars_fixture():
    """Shared full-KITTI-scale fixture (B=2, 12k pillars, 432x496 BEV
    grid — the reference config's exact workload): built network,
    loss config, fresh train state, and one synthetic device batch."""
    import jax
    import jax.numpy as jnp

    from papc_tpu.detect import builders
    from papc_tpu.detect.config import (
        DEFAULT_CONFIG_PATH,
        cfg_from_yaml_file,
    )
    from papc_tpu.train.trainer import TrainState

    cfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    model = builders.build_network(cfg, vg, ta)
    loss_cfg = builders.build_loss_config(cfg, ta)
    Bd, V, P = 2, 12000, 100
    grid = vg.grid_size
    A = (grid[0] // 2) * (grid[1] // 2) * 2
    rs = np.random.RandomState(0)
    batch = {
        "voxels": jnp.asarray(rs.randn(Bd, V, P, 4), jnp.float32),
        "num_points": jnp.asarray(
            rs.randint(1, P, size=(Bd, V)), jnp.int32
        ),
        "coordinates": jnp.asarray(
            np.stack(
                [
                    np.zeros((Bd, V)),
                    rs.randint(0, grid[1], (Bd, V)),
                    rs.randint(0, grid[0], (Bd, V)),
                ],
                -1,
            ),
            jnp.int32,
        ),
        "anchors": jnp.asarray(
            np.tile(
                np.array([0.0, 0, -1, 1.6, 3.9, 1.56, 0], np.float32),
                (Bd, A, 1),
            )
        ),
        "labels": jnp.asarray(
            rs.randint(-1, 2, size=(Bd, A)), jnp.int32
        ),
        "reg_targets": jnp.asarray(
            rs.randn(Bd, A, 7) * 0.1, jnp.float32
        ),
    }
    if model.pfn_flat:
        # flat real-point view (the loader's production output for
        # PFN_FLAT; cap matches MAX_POINTS_PER_FRAME)
        from papc_tpu.detect.pfn_fast import flatten_pillars

        pts, owner = flatten_pillars(
            np.asarray(batch["voxels"]),
            np.asarray(batch["num_points"]),
            np.asarray(batch["coordinates"]),
            25600,
        )
        batch["points_flat"] = jnp.asarray(pts)
        batch["point_pillar"] = jnp.asarray(owner)
        # "voxels" stays in the fixture for classic-path experiments;
        # the flat train step never reads it (XLA prunes the input)
    rng = jax.random.PRNGKey(0)
    variables = model.init(
        rng,
        batch.get("voxels"),
        batch["num_points"],
        batch["coordinates"],
        train=False,
        points=batch.get("points_flat"),
        point_pillar=batch.get("point_pillar"),
    )
    tx = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER)
    state = TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=tx,
    )
    return {
        "cfg": cfg, "model": model, "loss_cfg": loss_cfg, "ta": ta,
        "coder": coder, "state": state, "batch": batch, "Bd": Bd,
    }


def bench_pointpillars_step(precision="fp32", measure_infer=True):
    """Per-call PointPillars train step at the reference workload
    (fetch-forced; includes the per-call host dispatch)."""
    from papc_tpu.detect import builders
    from papc_tpu.detect.train import make_detection_train_step
    from papc_tpu.utils.timing import compiled_flops

    fx = _pointpillars_fixture()
    model, loss_cfg, batch = fx["model"], fx["loss_cfg"], fx["batch"]
    cfg, ta, coder, Bd = fx["cfg"], fx["ta"], fx["coder"], fx["Bd"]
    train_step, init_rm = make_detection_train_step(
        model, loss_cfg, precision=precision
    )
    holder = {"s": fx["state"], "rm": init_rm()}

    def step():
        s, m, rm = train_step(holder["s"], batch, holder["rm"])
        holder["s"], holder["rm"] = s, rm
        return m["loss"]

    flops = compiled_flops(
        train_step, holder["s"], batch, holder["rm"]
    )
    train_t, train_mfu = _device_time(
        step, ks=(5, 20), flops=flops,
        label=f"pointpillars_{precision}", precision=precision,
    )

    if not measure_infer:  # skip the predict compiles (bf16 rerun)
        return train_t, train_mfu, None

    # inference: decode -> score threshold -> top-k -> rotated NMS@1000.
    # Three rows: the PRODUCTION serving path is the flat-points input
    # (the loader's PFN_FLAT output) in bf16 (make_predict_step(
    # precision="bf16"): network fwd bf16, decode/NMS f32); the
    # voxel-grid fp32 row is the classic PFN input.
    from papc_tpu.detect.train import make_predict_step

    predict_cfg = builders.build_predict_config(cfg, ta)
    infer = {}
    legacy_batch = {k: batch[k] for k in
                    ("voxels", "num_points", "coordinates", "anchors")}
    arms = [("legacy_voxel_fp32", "fp32", legacy_batch)]
    if "points_flat" in batch:
        flat_batch = {k: batch[k] for k in
                      ("points_flat", "point_pillar", "num_points",
                       "coordinates", "anchors")}
        arms += [("flat_fp32", "fp32", flat_batch),
                 ("flat_bf16", "bf16", flat_batch)]
    for name, prec, ibatch in arms:
        predict_step = make_predict_step(
            model, predict_cfg, coder, precision=prec
        )

        def istep(_ps=predict_step, _ib=ibatch):
            return _ps(holder["s"], _ib)["scores"]

        infer[name] = _device_time(istep, ks=(5, 20))[0] / Bd
    return train_t, train_mfu, infer


def bench_pointpillars_step_scanned(precision="fp32", k_small=2,
                                    k_large=8):
    """Device-true PointPillars step: K steps scanned inside ONE jit
    (``make_scan_detection_train_step`` — the production
    ``TRAIN_CONFIG.SCAN_STEPS`` path), per-step from the whole-call
    slope. Excludes the per-call host dispatch. K kept small: each
    stacked KITTI batch is ~38 MB of pillars."""
    import jax
    import jax.numpy as jnp

    from papc_tpu.detect.train import (
        make_detection_train_step,
        make_scan_detection_train_step,
    )
    from papc_tpu.utils.timing import (
        check_physical,
        compiled_flops,
        fetch_forced_time,
        scan_slope,
    )

    fx = _pointpillars_fixture()
    model, loss_cfg, batch = fx["model"], fx["loss_cfg"], fx["batch"]
    train_step, init_rm = make_detection_train_step(
        model, loss_cfg, precision=precision
    )
    scan_step = make_scan_detection_train_step(
        model, loss_cfg, precision=precision
    )
    # trace-only; do it before the windows donate the fixture state
    flops = compiled_flops(train_step, fx["state"], batch, init_rm())

    def whole_call_time(k):
        stacked = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (k,) + x.shape), batch
        )
        # fresh copy per window (the scanned step donates the state)
        holder = {
            "s": jax.tree_util.tree_map(jnp.copy, fx["state"]),
            "rm": init_rm(),
        }

        def call():
            holder["s"], mk, holder["rm"] = scan_step(
                holder["s"], stacked, holder["rm"]
            )
            return mk["loss"]

        res = fetch_forced_time(call, k_small=2, k_large=5, repeats=3)
        return res.step_s

    res = scan_slope(whole_call_time, k_small, k_large)
    mfu = check_physical(
        res.step_s, flops, f"pointpillars_scan_{precision}",
        _peak_precision(precision),
    )
    return res.step_s, mfu, flops


def bench_zoo_steps(k_small=4, k_large=16):
    """One device-true (scan-slope) train-step time per clas zoo family
    beyond the SSG headline — VoxNet (voxel grids), KDNet (kd-tree
    leaves), PointNet (T-Net clouds), VFE (tile+concat) — so "the zoo
    is fast" is a recorded number, not an inference.
    Same trainer and scan path as the headline; kept cheap (small K,
    2 repeats)."""
    import jax
    import jax.numpy as jnp

    from papc_tpu.models import init_model
    from papc_tpu.train.trainer import (
        create_train_state,
        make_scan_train_step,
    )
    from papc_tpu.utils.timing import fetch_forced_time, scan_slope

    rs = np.random.RandomState(0)

    def make_batch(spec):
        batch = {
            "label": jnp.asarray(rs.randint(0, 16, size=(B,))),
            "mask": jnp.ones((B,), bool),
        }
        if spec.input_kind == "voxel":
            batch["voxels"] = jnp.asarray(
                (rs.rand(B, 32, 32, 32, 1) > 0.9), jnp.float32
            )
        else:
            batch["points"] = jnp.asarray(
                rs.randn(B, N, 3), jnp.float32
            )
        if spec.input_kind == "kd":
            depth = int(np.log2(N))
            batch["split_dims"] = tuple(
                jnp.asarray(rs.randint(0, 3, size=(B, N >> l)))
                for l in range(depth)
            )
        return batch

    out = {}
    for name in ("voxnet", "kdnet", "pointnet", "vfe"):
        spec = init_model(name, "clas", num_classes=16)
        batch = make_batch(spec)
        rng = jax.random.PRNGKey(0)
        state = create_train_state(spec, rng, batch)

        def whole_call_time(k, _spec=spec, _batch=batch, _state=state,
                            _rng=rng):
            scan_step = make_scan_train_step(_spec, k)
            stacked = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x[None], (k,) + x.shape),
                _batch,
            )
            holder = {"s": jax.tree_util.tree_map(jnp.copy, _state)}

            def call():
                holder["s"], losses, _ = scan_step(
                    holder["s"], stacked, _rng
                )
                return losses

            return fetch_forced_time(
                call, k_small=2, k_large=4, repeats=2
            ).step_s

        res = scan_slope(whole_call_time, k_small, k_large)
        out[name] = res.step_s
    return out


def bench_fps_large_n():
    """FPS at large N (B=4, N=16384, npoint=2048): the plain XLA
    fori_loop vs the Pallas-Triton kernel (papc_tpu/ops/pallas/fps.py,
    the automatic choice on CUDA)."""
    import functools

    import jax
    import jax.numpy as jnp

    from papc_tpu.ops import farthest_point_sample

    rs = np.random.RandomState(0)
    xyz = jnp.asarray(rs.randn(4, 16384, 3), jnp.float32)
    out = {}
    for backend in ("xla", "triton"):
        base = functools.partial(
            farthest_point_sample,
            npoint=2048,
            start_idx=0,
            backend=backend,
        )

        @jax.jit
        def chained(x):
            idx = base(x)
            return idx, x + (idx.sum() * 0).astype(x.dtype)

        holder = {"x": xyz}

        def step():
            idx, holder["x"] = chained(holder["x"])
            return idx

        out[backend] = _device_time(step, ks=(3, 12))[0]
    return out


def bench_ball_query_large_n():
    """Ball query at large N (B=4, N=16384, S=2048, nsample=32): the XLA
    [B,S,N]-matrix + top_k path."""
    import jax
    import jax.numpy as jnp

    from papc_tpu.ops import query_ball_point

    rs = np.random.RandomState(0)
    xyz = jnp.asarray(rs.randn(4, 16384, 3), jnp.float32)
    q = xyz[:, :2048]

    @jax.jit
    def chained(x, qq):
        idx = query_ball_point(0.4, 32, x, qq)
        return idx, x + (idx.sum() * 0).astype(x.dtype)

    holder = {"x": xyz}

    def step():
        idx, holder["x"] = chained(holder["x"], q)
        return idx

    return _device_time(step, ks=(3, 12))[0]


def bench_rotated_iou():
    """N×K exact rotated IoU at KITTI-eval scale (128×128 boxes, one
    SECOND sample per the reference's docstring claims): device jnp
    kernel vs the C++ host kernel. Reference baselines: C++/boost
    <50 ms/sample (``box_np_ops.py:17``), numba-CUDA ~5 ms/sample
    (``nms_gpu.py:525-527``)."""
    import jax
    import jax.numpy as jnp

    from papc_tpu import cc
    from papc_tpu.ops.iou import rotate_iou

    rs = np.random.RandomState(0)
    def boxes(n):
        return np.stack(
            [
                rs.uniform(0, 60, n),
                rs.uniform(-30, 30, n),
                rs.uniform(1.5, 2.0, n),
                rs.uniform(3.5, 4.5, n),
                rs.uniform(-np.pi, np.pi, n),
            ],
            axis=1,
        ).astype(np.float32)

    a, b = boxes(128), boxes(128)
    aj, bj = jnp.asarray(a), jnp.asarray(b)

    @jax.jit
    def dev(x, y):
        out = rotate_iou(x, y)
        return out, x + (out.sum() * 0).astype(x.dtype)

    holder = {"x": aj}

    def step():
        o, holder["x"] = dev(holder["x"], bj)
        return o

    t_dev = _device_time(step)[0]
    cc.rbbox_iou(a, b)
    t0 = time.perf_counter()
    for _ in range(20):
        cc.rbbox_iou(a, b)
    t_cc = (time.perf_counter() - t0) / 20
    return t_dev, t_cc


def card_info() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench: JAX platform is {device.platform!r}, not 'gpu'",
              file=sys.stderr)
        return 1

    from papc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    t_start = time.time()
    failed = []

    def safe(fn, *a, default=None, **k):
        """Run one stage; a failure is reported on stderr and recorded
        in ``failed_stages`` (and the exit code), not hidden. stdout
        carries ONE JSON line."""
        name = fn.__name__ + (f" {k}" if k else "")
        print(f"# [{time.time() - t_start:6.0f}s] bench stage {name}",
              file=sys.stderr, flush=True)
        try:
            return fn(*a, **k)
        except Exception as e:  # noqa: BLE001 — reported, not hidden
            import traceback

            traceback.print_exc(file=sys.stderr)
            failed.append(f"{name}: {e!r:.300}")
            return default

    riou = safe(bench_rotated_iou, default=(None, None))
    device_pillarize_s = safe(bench_device_pillarize)
    step_time, step_mfu, step_flops, step_flops_xla = safe(
        bench_train_step, default=(None, None, None, None)
    )
    bf16 = safe(bench_train_step, precision="bf16",
                default=(None, None, None, None))
    step_time_bf16, step_mfu_bf16, _, _ = bf16
    # device-true scanned stepping (production train(scan_steps=K));
    # headline throughput uses it when available — it IS the deployed
    # fast path, and it excludes host dispatch that is not device work
    scanned = safe(bench_train_step_scanned, default=(None, None, None))
    scan_time, scan_mfu, _ = scanned
    scanned_bf16 = safe(bench_train_step_scanned, precision="bf16",
                        default=(None, None, None))
    scan_time_bf16, scan_mfu_bf16, _ = scanned_bf16
    headline_time = scan_time or step_time
    pts_per_sec = B * N / headline_time if headline_time else None
    epoch_time = (
        headline_time * (SHAPENET_TRAIN_SAMPLES // B)
        if headline_time else None
    )
    pp = safe(bench_pointpillars_step, default=(None, None, None))
    pp_step, pp_mfu, pp_infer = pp
    pp_infer = pp_infer or {}
    pp_bf16 = safe(
        bench_pointpillars_step, precision="bf16", measure_infer=False,
        default=(None, None, None),
    )
    pp_step_bf16, pp_mfu_bf16, _ = pp_bf16
    pp_scan = safe(
        bench_pointpillars_step_scanned, default=(None, None, None)
    )
    pp_scan_step, pp_scan_mfu, _ = pp_scan
    pp_scan_bf16 = safe(
        bench_pointpillars_step_scanned, precision="bf16",
        default=(None, None, None),
    )
    pp_scan_step_bf16, pp_scan_mfu_bf16, _ = pp_scan_bf16
    pillarize_s, pillarize_kernel_s = safe(
        bench_pillarize, default=(None, None)
    )
    zoo = safe(bench_zoo_steps, default={}) or {}
    fps_large = safe(bench_fps_large_n, default={}) or {}
    bq_large = safe(bench_ball_query_large_n)
    riou_dev, riou_cc = riou

    def ms(x, nd=3):
        return round(x * 1e3, nd) if x is not None else None

    def pct(x):
        return round(x * 100, 2) if x is not None else None

    print(
        json.dumps(
            {
                "metric": "shapenet_clas_points_per_sec_per_chip",
                "value": round(pts_per_sec, 1) if pts_per_sec else None,
                "unit": "points/sec",
                "vs_baseline": (
                    round(pts_per_sec / BASELINE_POINTS_PER_SEC, 2)
                    if pts_per_sec else None
                ),
                "extra": {
                    "model": "pointnet2_ssg",
                    "batch": B,
                    "points": N,
                    "card": card_info(),
                    "device_kind": device.device_kind,
                    "device_count": len(jax.devices()),
                    # fp32 rows: jax's default matmul precision, which
                    # the GPU runs in TF32; MFU against the TF32 peak
                    "matmul_precision": {
                        "fp32_rows": "default (TF32)",
                        "bf16_rows": "bf16",
                    },
                    "timing_method": (
                        "fetch-forced K-chain slope "
                        "(papc_tpu.utils.timing)"
                    ),
                    "failed_stages": failed,
                    "step_ms": ms(step_time),
                    # MFU from ANALYTIC model FLOPs (ssg_analytic_train_
                    # flops); XLA's count is kept as *_xla_counted
                    "step_mfu_pct": pct(step_mfu),
                    "step_flops_analytic": step_flops,
                    "step_flops_xla_counted": step_flops_xla,
                    "step_ms_bf16": ms(step_time_bf16),
                    "step_bf16_mfu_pct": pct(step_mfu_bf16),
                    "scan_step_ms": ms(scan_time),
                    "scan_step_mfu_pct": pct(scan_mfu),
                    "scan_step_ms_bf16": ms(scan_time_bf16),
                    "scan_step_bf16_mfu_pct": pct(scan_mfu_bf16),
                    "pointnet2_ssg_epoch_sec": (
                        round(epoch_time, 2) if epoch_time else None
                    ),
                    "pillarize_ms_per_frame": ms(pillarize_s),
                    "pillarize_kernel_ms_per_frame": ms(
                        pillarize_kernel_s
                    ),
                    "device_pillarize_ms_per_frame": ms(
                        device_pillarize_s
                    ),
                    "pointpillars_step_ms": ms(pp_step),
                    "pointpillars_step_mfu_pct": pct(pp_mfu),
                    "pointpillars_step_ms_bf16": ms(pp_step_bf16),
                    "pointpillars_bf16_mfu_pct": pct(pp_mfu_bf16),
                    "pointpillars_scan_step_ms": ms(pp_scan_step),
                    "pointpillars_scan_step_mfu_pct": pct(pp_scan_mfu),
                    "pointpillars_scan_step_ms_bf16": ms(
                        pp_scan_step_bf16
                    ),
                    "pointpillars_scan_bf16_mfu_pct": pct(
                        pp_scan_mfu_bf16
                    ),
                    # voxel-grid input fp32, flat-points fp32, and the
                    # PRODUCTION serving path (flat points + bf16 forward)
                    "pointpillars_infer_ms_per_frame": ms(
                        pp_infer.get("legacy_voxel_fp32")
                    ),
                    "pointpillars_infer_ms_per_frame_flat": ms(
                        pp_infer.get("flat_fp32")
                    ),
                    "pointpillars_infer_ms_per_frame_bf16": ms(
                        pp_infer.get("flat_bf16")
                    ),
                    "zoo_step_ms": {
                        k: ms(v) for k, v in sorted(zoo.items())
                    },
                    "fps_16k_xla_ms": ms(fps_large.get("xla"), 2),
                    "fps_16k_triton_ms": ms(fps_large.get("triton"), 2),
                    "ball_query_16k_xla_ms": ms(bq_large, 2),
                    # reference claims: C++/boost <50 ms, numba-CUDA
                    # ~5 ms per SECOND sample (BASELINE.md)
                    "rotated_iou_128x128_device_ms": ms(riou_dev),
                    "rotated_iou_128x128_cc_ms": ms(riou_cc),
                    # vs_baseline divides by a DOCUMENTED ESTIMATE, not
                    # a measurement — the reference publishes no numbers
                    # and cannot run here (Paddle+CUDA); see BASELINE.md
                    "baseline_points_per_sec": BASELINE_POINTS_PER_SEC,
                    "baseline_kind": "documented estimate (BASELINE.md)",
                },
            }
        )
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
