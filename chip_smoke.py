"""Run the main path once on one NVIDIA GPU and check what comes out.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # only the 4-card data-parallel phase

Phases (one card):

1. device — JAX must report a ``gpu`` platform; there is no CPU fallback.
2. fps — the Pallas-Triton FPS kernel against the plain XLA loop and a
   float32 numpy oracle at 32x1024->512, 32x512->128 and 4x16384->2048.
3. ssg — PointNet++ SSG classification training at the reference widths
   (B=32, N=1024, 16 classes) through the trainer's step builders:
   per-call and scanned (K=8) steps in fp32 and bf16 on one fixed
   in-memory batch, and the first step against the CPU backend under
   ``jax.default_matmul_precision("highest")``.
4. pointpillars — the shipped car config at its published sizes (batch 2,
   12000 pillars x 100 points, 432x496 canvas) on synthetic lidar frames
   pillarized on the host: 3 train steps, one scanned call, and one
   predict frame (host pillarize -> forward -> rotated NMS, pre 1000 /
   post 300).

Each phase prints one line of its numbers, tagged with the card's name and
power limit and the matmul precision it ran at. A failed phase raises, so
the run exits non-zero; the last line, printed only when every phase
passed, is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Reporter:
    def __init__(self, card: str):
        self.card = card

    def phase(self, name: str, precision: str, **numbers) -> None:
        fields = " ".join(f"{k}={v}" for k, v in numbers.items())
        print(f"[{name}] card={self.card!r} matmul_precision={precision} "
              f"{fields}", flush=True)


def _ms(fn, *args, reps: int = 10) -> float:
    """Mean wall ms of ``fn(*args)`` after a warm call, ending on
    ``block_until_ready`` (a real barrier on the GPU)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# -- FPS ----------------------------------------------------------------

def fps_oracle(x: np.ndarray, npoint: int) -> np.ndarray:
    """float32 numpy FPS from index 0 (the reference recursion)."""
    B, N, _ = x.shape
    out = np.zeros((B, npoint), np.int64)
    dist = np.full((B, N), np.inf, np.float32)
    far = np.zeros(B, np.int64)
    rows = np.arange(B)
    for i in range(npoint):
        out[:, i] = far
        d = ((x - x[rows, far][:, None, :]) ** 2).sum(-1, dtype=np.float32)
        dist = np.minimum(dist, d)
        far = dist.argmax(-1)
    return out


def picked_min_dist(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Squared distance of each pick to the picks before it (float64),
    the quantity the argmax maximizes; 0 for the first pick."""
    out = np.zeros(idx.shape, np.float64)
    for b in range(len(idx)):
        p = x[b, idx[b]].astype(np.float64)
        d = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        d[np.triu_indices(len(p))] = np.inf
        out[b, 1:] = d[1:].min(1)
    return out


FPS_SHAPES = ((32, 1024, 512), (32, 512, 128), (4, 16384, 2048))


def phase_fps(rep: Reporter, shapes=FPS_SHAPES) -> None:
    import jax
    import jax.numpy as jnp

    from papc_tpu.ops.sampling import farthest_point_sample

    rng = np.random.RandomState(0)
    for B, N, S in shapes:
        x = (rng.rand(B, N, 3) * 10).astype(np.float32)
        xj = jnp.asarray(x)
        fns = {
            b: jax.jit(lambda v, b=b: farthest_point_sample(
                v, S, start_idx=0, backend=b))
            for b in ("triton", "xla")
        }
        got = {b: np.asarray(f(xj)) for b, f in fns.items()}
        ms = {b: _ms(f, xj) for b, f in fns.items()}
        oracle = fps_oracle(x, S)
        agree = float(np.mean(got["triton"] == got["xla"]))
        agree_oracle = float(np.mean(got["triton"] == oracle))
        dk = picked_min_dist(x, got["triton"])
        dx = picked_min_dist(x, got["xla"])
        rel = float(np.max(np.abs(dk - dx) / np.maximum(np.abs(dx), 1e-30)))
        rep.phase(
            "fps", "n/a (elementwise)", shape=f"{B}x{N}->{S}",
            agree_xla=agree, agree_oracle=agree_oracle,
            picked_dist_max_rel=rel, triton_ms=round(ms["triton"], 4),
            xla_ms=round(ms["xla"], 4),
        )
        # ties: two equally far points are picked by index on every
        # path; the distances can only differ in rounding, so the picked
        # sequence must agree to float32 resolution
        check(agree >= 0.999, f"FPS {B}x{N}: {agree:.5f} agreement < 0.999")
        check(rel <= 1e-6, f"FPS {B}x{N}: picked distances differ by {rel}")
        check(got["triton"].max() < N, f"FPS {B}x{N}: padded point picked")


# -- PointNet++ SSG ------------------------------------------------------

def phase_ssg(rep: Reporter, B=32, N=1024, C=16, K=8, STEPS=20) -> None:
    import jax
    import jax.numpy as jnp

    from papc_tpu.data.synthetic import make_batch
    from papc_tpu.models import init_model
    from papc_tpu.train.trainer import (
        create_train_state,
        make_scan_train_step,
        make_train_step,
        stack_batches,
    )

    spec = init_model("pointnet2_ssg", "clas", num_classes=C, max_point=N)
    host_batch = make_batch(B, N, C, seed=0)
    batch = jax.tree_util.tree_map(jnp.asarray, host_batch)
    key = jax.random.PRNGKey(0)
    state0 = create_train_state(spec, key, batch)

    def fresh(device=None):
        s = jax.tree_util.tree_map(jnp.copy, state0)
        return s if device is None else jax.device_put(s, device)

    # first step on the GPU against the CPU backend, both at full f32
    step_hi, _ = make_train_step(spec)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        _, loss_gpu, _ = step_hi(fresh(), batch, key)
        _, loss_cpu, _ = step_hi(
            fresh(cpu), jax.device_put(host_batch, cpu),
            jax.device_put(key, cpu),
        )
    loss_gpu, loss_cpu = float(loss_gpu), float(loss_cpu)
    rel_cpu = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    rep.phase("ssg", "highest", check="first step vs CPU",
              loss_gpu=loss_gpu, loss_cpu=loss_cpu, rel=rel_cpu)
    # both sides are full f32; what remains is summation order (cuBLAS
    # vs Eigen, atomic scatter-adds), orders below 1e-3 of the loss
    check(rel_cpu <= 1e-3, f"SSG first step vs CPU: rel {rel_cpu:.2e} > 1e-3")

    stacked = jax.tree_util.tree_map(
        jnp.asarray, stack_batches([host_batch] * K)
    )
    for precision in ("fp32", "bf16"):
        train_step, _ = make_train_step(spec, precision=precision)
        state, losses = fresh(), []
        for i in range(STEPS):
            state, loss, acc = train_step(state, batch, jax.random.PRNGKey(i))
            losses.append(float(loss))
        t0 = time.perf_counter()
        for _ in range(5):
            state, loss, _ = train_step(state, batch, key)
        jax.block_until_ready(loss)
        ms_step = (time.perf_counter() - t0) / 5 * 1e3
        scan_step = make_scan_train_step(spec, K, precision=precision)
        s2, scan_losses, _ = scan_step(fresh(), stacked, key)
        scan_losses = np.asarray(scan_losses)
        first_rel = abs(losses[0] - loss_gpu) / abs(loss_gpu)
        # fp32 runs at the default matmul precision (TF32 on the tensor
        # cores: 10-bit mantissas, ~5e-4 relative per rounding) and bf16
        # with 8-bit mantissas (~4e-3) in every activation; through ~12
        # Dense/BN layers and three max-pools (which may then pick
        # another neighbour) the first loss moves by up to a few
        # percent: bounds 5e-2 (TF32) and 0.15 (bf16)
        bound = 5e-2 if precision == "fp32" else 0.15
        rep.phase(
            "ssg", "default" if precision == "fp32" else "bf16",
            compute=precision, first_loss=round(losses[0], 5),
            last_loss=round(losses[-1], 5), first_vs_highest_rel=first_rel,
            scan_losses=np.round(scan_losses, 4).tolist(),
            step_ms_single_call=round(ms_step, 3),
        )
        check(np.isfinite(losses).all() and np.isfinite(scan_losses).all(),
              f"SSG {precision}: non-finite loss")
        check(losses[-1] < 0.8 * losses[0],
              f"SSG {precision}: loss did not fall over {STEPS} steps "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
        check(scan_losses[-1] < scan_losses[0],
              f"SSG {precision}: scanned loss did not fall {scan_losses}")
        check(first_rel <= bound,
              f"SSG {precision}: first loss {first_rel:.2e} from the "
              f"highest-precision loss (bound {bound})")


# -- PointPillars --------------------------------------------------------

def pillar_frames(cfg, vg, ta, n_frames: int, seed: int = 0):
    """Synthetic lidar frames → host-pillarized flat-PFN batches with
    anchors and targets, as the KITTI loader emits them."""
    from papc_tpu.data.synthetic_kitti import make_scene
    from papc_tpu.detect.pfn_fast import flatten_pillars
    from papc_tpu.detect.voxelize_np import points_to_voxel

    rng = np.random.RandomState(seed)
    reader = cfg.TRAIN_INPUT_READER
    max_voxels = int(reader.MAX_NUMBER_OF_VOXELS)
    max_points = int(reader.MAX_POINTS_PER_FRAME)
    grid = vg.grid_size
    fmap = [1, int(grid[1]) // 2, int(grid[0]) // 2]
    anc = ta.generate_anchors(fmap)
    anchors = anc["anchors"].reshape(-1, 7)
    frames, host_ms = [], []
    for _ in range(n_frames):
        pts, gt = make_scene(rng, num_cars=10, n_background=20000)
        t0 = time.perf_counter()
        vox, coords, npts = points_to_voxel(
            pts, vg.voxel_size, vg.point_cloud_range, vg.max_num_points,
            max_voxels, pad_output=True,
        )
        k = int((npts > 0).sum())
        coords = coords.copy()
        coords[k:] = -1
        flat, owner = flatten_pillars(
            vox[None], npts[None], coords[None], max_points
        )
        host_ms.append((time.perf_counter() - t0) * 1e3)
        tg = ta.assign(
            anchors, gt, gt_classes=np.ones(len(gt), np.int32),
            matched_thresholds=anc["matched_thresholds"],
            unmatched_thresholds=anc["unmatched_thresholds"],
        )
        frames.append({
            "points_flat": flat[0],
            "point_pillar": owner[0],
            "num_points": npts.astype(np.int32),
            "coordinates": coords.astype(np.int32),
            "anchors": anchors.astype(np.float32),
            "labels": tg["labels"].astype(np.int32),
            "reg_targets": tg["bbox_targets"].astype(np.float32),
        })
    return frames, host_ms


def phase_pointpillars(rep: Reporter, cfg=None) -> None:
    """``cfg``: the detection config; the shipped car config (at its
    published sizes) when None."""
    import jax
    import jax.numpy as jnp

    from papc_tpu.detect import builders
    from papc_tpu.detect.config import DEFAULT_CONFIG_PATH, cfg_from_yaml_file
    from papc_tpu.detect.train import (
        make_detection_train_step,
        make_predict_step,
        make_scan_detection_train_step,
    )
    from papc_tpu.train.trainer import TrainState

    shipped = cfg is None
    if shipped:
        cfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    model = builders.build_network(cfg, vg, ta)
    loss_cfg = builders.build_loss_config(cfg, ta)
    predict_cfg = builders.build_predict_config(cfg, ta)
    Bd = int(cfg.TRAIN_INPUT_READER.BATCH_SIZE)
    if shipped:
        check(tuple(int(g) for g in vg.grid_size[:2]) == (432, 496),
              f"car config grid {vg.grid_size}")

    frames, host_ms = pillar_frames(cfg, vg, ta, 2 * Bd + 1)

    def collate(fs):
        return {k: jnp.asarray(np.stack([f[k] for f in fs])) for k in fs[0]}

    batches = [collate(frames[i:i + Bd]) for i in (0, Bd)]
    b0 = batches[0]
    variables = model.init(
        jax.random.PRNGKey(0), None, b0["num_points"], b0["coordinates"],
        train=False, points=b0["points_flat"], point_pillar=b0["point_pillar"],
    )
    state = TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER),
    )
    train_step, init_rm = make_detection_train_step(model, loss_cfg)
    scan_step = make_scan_detection_train_step(model, loss_cfg)
    predict_step = make_predict_step(model, predict_cfg, coder)

    # the predict frame's state must survive the donated train steps
    eval_state = jax.tree_util.tree_map(jnp.copy, state)
    rm, losses = init_rm(), []
    for i in range(3):
        state, metrics, rm = train_step(state, batches[i % 2], rm)
        losses.append(float(metrics["loss"]))
    t0 = time.perf_counter()
    state, metrics, rm = train_step(state, batches[1], rm)
    jax.block_until_ready(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *batches)
    state, scan_metrics, rm = scan_step(state, stacked, rm)
    scan_losses = np.asarray(scan_metrics["loss"])
    rep.phase(
        "pointpillars", "default", batch=Bd,
        pillars=int(cfg.TRAIN_INPUT_READER.MAX_NUMBER_OF_VOXELS),
        losses=np.round(losses, 4).tolist(),
        scan_losses=np.round(scan_losses, 4).tolist(),
        step_ms_single_call=round(step_ms, 3),
        host_pillarize_ms_per_frame=round(float(np.mean(host_ms)), 3),
    )
    check(np.isfinite(losses).all() and np.isfinite(scan_losses).all(),
          "PointPillars: non-finite train loss")

    frame = collate(frames[-1:])
    frame = {k: frame[k] for k in
             ("points_flat", "point_pillar", "num_points", "coordinates",
              "anchors")}
    dets = predict_step(eval_state, frame)
    predict_ms = _ms(predict_step, eval_state, frame)
    boxes = np.asarray(dets["box3d_lidar"])
    post = int(predict_cfg.nms_post_max_size)
    rep.phase(
        "pointpillars_predict", "default",
        nms_pre=int(predict_cfg.nms_pre_max_size), nms_post=post,
        boxes_shape=list(boxes.shape), n_valid=int(np.sum(dets["valid"])),
        predict_ms_per_frame=round(predict_ms, 3),
    )
    check(boxes.shape == (1, post, 7), f"predict boxes {boxes.shape}")
    check(np.isfinite(boxes).all() and
          np.isfinite(np.asarray(dets["scores"])).all(),
          "PointPillars predict: non-finite boxes or scores")


# -- four cards ------------------------------------------------------------

def phase_four_cards(rep: Reporter, B=32, N=1024, C=16) -> None:
    """One SSG train step (B=32) data-parallel over 4 cards against the
    same global batch on one card, both at full f32 matmul precision."""
    import jax

    from papc_tpu.data.synthetic import make_batch
    from papc_tpu.models import init_model
    from papc_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from papc_tpu.train.trainer import create_train_state, make_train_step

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    spec = init_model("pointnet2_ssg", "clas", num_classes=C, max_point=N)
    host_batch = make_batch(B, N, C, seed=0)
    key = jax.random.PRNGKey(0)
    train_step, _ = make_train_step(spec)
    params0 = jax.device_get(
        create_train_state(spec, key, host_batch, 1e-3, 0.0).params
    )

    def run(n):
        mesh = make_mesh(n_data=n, devices=jax.devices()[:n])
        state = create_train_state(spec, key, host_batch, 1e-3, 0.0)
        state = replicate(mesh, state)
        with jax.default_matmul_precision("highest"):
            state, loss, _ = train_step(
                state, shard_batch(mesh, host_batch), jax.random.PRNGKey(1)
            )
        return float(loss), jax.device_get(state.params)

    l1, p1 = run(1)
    l4, p4 = run(4)
    loss_rel = abs(l1 - l4) / abs(l1)
    # Adam's first update is ~lr * sign(grad) for every entry, so the
    # updates agree exactly where the gradient signs do
    d1, d4, p0 = (jax.tree_util.tree_leaves(p) for p in (p1, p4, params0))
    same = sum(int(np.sum(np.sign(a - c) == np.sign(b - c)))
               for a, b, c in zip(d1, d4, p0))
    total = sum(c.size for c in p0)
    agree = same / total
    rep.phase("four_cards", "highest", devices=4, loss_1=l1, loss_4=l4,
              loss_rel=loss_rel, update_sign_agreement=agree)
    # same math; the all-reduce and the global BatchNorm moments sum in
    # another order, and BatchNorm's E[x^2]-E[x]^2 variance amplifies
    # that where a channel's mean dwarfs its spread
    check(loss_rel <= 1e-3, f"DP loss differs by {loss_rel:.2e} > 1e-3")
    # entries whose gradient is float noise (biases ahead of BatchNorm,
    # ~0.1% of the parameters) may move either way; the rest must not
    check(agree >= 0.99, f"DP updates agree in sign for {agree:.4f} < 0.99")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX platform is {platform!r}, not 'gpu'; "
              "this check needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from papc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    rep = Reporter(card_info())
    rep.phase("device", "n/a", platform=platform,
              kind=repr(devices[0].device_kind), count=len(devices))
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(rep)
    else:
        phase_fps(rep)
        phase_ssg(rep)
        phase_pointpillars(rep)
    print(f"[done] card={rep.card!r} seconds={time.perf_counter() - t0:.1f}")
    print(rep.card)
    print(json.dumps({"ok": True, "device": {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
