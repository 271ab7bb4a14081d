"""Single trainer for the whole clas/seg zoo.

Reference parity: ``PAPC/train.py`` — same public ``train(...)`` signature
(model_name, mode, max_point, num_classes, num_parts, learning_rate,
weight_decay, epoch_num, batchsize, info_iter, save_iter, path), same
Adam(+L2) optimizer, same per-``info_iter`` loss/accuracy/mIoU prints,
checkpoints every ``save_iter`` epochs, a val pass each epoch.

Differences from the reference: one jitted train step (donated state)
per model; fixed-shape padded batches; data-parallel over a device mesh
by default; ``.npz`` checkpoints with resume.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from papc_tpu.models import ModelSpec, init_model
from papc_tpu.parallel.mesh import make_mesh_for_batch, replicate, shard_batch
from papc_tpu.train import checkpoint as ckpt_lib
from papc_tpu.train import metrics as M


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step", "params", "opt_state", "batch_stats"],
    meta_fields=["apply_fn", "tx"],
)
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Parameters, optimizer state and BatchNorm statistics of one model;
    a pytree whose ``apply_fn`` and ``tx`` are static."""

    step: Any
    params: Any
    opt_state: Any
    batch_stats: Any
    apply_fn: Callable
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, *, apply_fn, params, tx, batch_stats=None):
        return cls(0, params, tx.init(params), batch_stats, apply_fn, tx)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(
            grads, self.opt_state, self.params
        )
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state,
        )


def make_optimizer(
    learning_rate: float, weight_decay: float
) -> optax.GradientTransformation:
    """Adam with paddle-style L2 regularization (decay added to the grad
    BEFORE the Adam transform — reference ``PAPC/train.py:62-65``)."""
    return optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.adam(learning_rate),
    )


def model_inputs(spec: ModelSpec, batch: dict):
    """Positional model args for a batch, per input kind/mode."""
    if spec.input_kind == "voxel":
        return (batch["voxels"],)
    if spec.input_kind == "kd":
        return (batch["points"], batch["split_dims"])
    if spec.mode == "seg":
        return (batch["points"], batch["label"])
    return (batch["points"],)


def targets_of(spec: ModelSpec, batch: dict):
    return batch["pid"] if spec.mode == "seg" else batch["label"]


def create_train_state(
    spec: ModelSpec,
    rng: jax.Array,
    sample_batch: dict,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-3,
) -> TrainState:
    inputs = model_inputs(spec, sample_batch)
    variables = spec.model.init(
        {"params": rng, "dropout": rng}, *inputs, train=False
    )
    return TrainState.create(
        apply_fn=spec.model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=make_optimizer(learning_rate, weight_decay),
    )


def make_train_step(
    spec: ModelSpec, num_parts: int = 50, precision: str = "fp32"
):
    """Build the jitted training step for a model spec.

    ``precision='bf16'`` runs the forward/backward in bfloat16 — the
    mixed-precision mode (params, optimizer state, and BN
    running stats stay fp32 masters; activations and the backward pass
    are bf16; the loss reduces in fp32). bf16's fp32-sized exponent makes
    the reference's fp16 loss-scaling machinery (``libs/tools/optim.py``)
    unnecessary, though :mod:`papc_tpu.train.precision` still provides it.
    """
    from papc_tpu.train.precision import cast_floating

    bf16 = precision == "bf16"
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")

    def loss_fn(params, batch_stats, batch, dropout_rng):
        if bf16:
            params = cast_floating(params, jnp.bfloat16)
            batch = cast_floating(batch, jnp.bfloat16)
        inputs = model_inputs(spec, batch)
        out, mutated = spec.model.apply(
            {"params": params, "batch_stats": batch_stats},
            *inputs,
            train=True,
            mutable=["batch_stats"],
            rngs={"dropout": dropout_rng},
        )
        targets = targets_of(spec, batch)
        loss = M.softmax_cross_entropy(
            out.astype(jnp.float32), targets, batch["mask"]
        )
        # keep BN running stats fp32 regardless of compute dtype — a
        # bf16 leaf here alternates the state dtype step-over-step and
        # forces an XLA recompile every step
        new_stats = cast_floating(mutated["batch_stats"], jnp.float32)
        return loss, (out, new_stats)

    def step_impl(state: TrainState, batch: dict, dropout_rng):
        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params, state.batch_stats, batch, dropout_rng)
        state = state.apply_gradients(grads=grads)
        state = state.replace(batch_stats=new_stats)
        targets = targets_of(spec, batch)
        if spec.mode == "seg":
            metric = M.mean_iou(logits, targets, num_parts, batch["mask"])
        else:
            metric = M.accuracy(logits, targets, batch["mask"])
        return state, loss, metric

    train_step = functools.partial(jax.jit, donate_argnums=(0,))(
        step_impl
    )
    # the un-jitted update, for composition inside larger jitted
    # programs (make_scan_train_step's lax.scan body)
    train_step.impl = step_impl

    @jax.jit
    def eval_step(state: TrainState, batch: dict):
        inputs = model_inputs(spec, batch)
        logits = spec.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            *inputs,
            train=False,
        )
        targets = targets_of(spec, batch)
        loss = M.softmax_cross_entropy(logits, targets, batch["mask"])
        if spec.mode == "seg":
            metric = M.mean_iou(logits, targets, num_parts, batch["mask"])
        else:
            metric = M.accuracy(logits, targets, batch["mask"])
        return loss, metric

    return train_step, eval_step


def make_scan_train_step(
    spec: ModelSpec,
    scan_steps: int,
    num_parts: int = 50,
    precision: str = "fp32",
):
    """K train steps scanned inside ONE jitted call.

    Takes a stacked batch pytree (leading axis ``scan_steps``) and a
    base rng; runs ``lax.scan`` over the same per-step update as
    :func:`make_train_step` with the state as donated carry. Returns
    ``(state, losses [K], metrics [K])``.

    Why: each jitted call pays a host dispatch, which can be a large
    part of a small step. Scanning K steps per call amortizes that to
    1/K and lets the device run back-to-back steps with no host in the
    loop. The reference's python train loop (``PAPC/train.py:96-117``)
    has no analog — it syncs every step.

    The scanned program is a single XLA computation, so all K batches
    must be resident; keep K modest (8–64) for device memory.
    """
    from jax import lax

    train_step, _ = make_train_step(spec, num_parts, precision)
    step_impl = train_step.impl

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scan_train_step(state: TrainState, stacked_batch: dict, rng):
        # lax.scan takes K from the stacked batch; enforce the declared
        # contract so step accounting (train() counts scan_steps done
        # per call) can never silently drift from the executed count.
        for leaf in jax.tree_util.tree_leaves(stacked_batch):
            if leaf.shape[0] != scan_steps:
                raise ValueError(
                    f"stacked batch leading axis {leaf.shape[0]} != "
                    f"scan_steps={scan_steps}"
                )

        def body(carry, batch):
            st, r = carry
            r, sub = jax.random.split(r)
            st, loss, metric = step_impl(st, batch, sub)
            return (st, r), (loss, metric)

        (state, _), (losses, metrics) = lax.scan(
            body, (state, rng), stacked_batch
        )
        return state, losses, metrics

    return scan_train_step


def stack_batches(batches: list) -> dict:
    """Stack K same-shape batch dicts into one [K, ...] pytree (host
    side, for :func:`make_scan_train_step`)."""
    return jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *batches
    )


def _state_dict(state: TrainState) -> dict:
    return {
        "params": state.params,
        "opt_state": state.opt_state,
        "batch_stats": state.batch_stats,
        "step": state.step,
    }


def save_checkpoint(state: TrainState, model_dir: str, name: str, epoch: int):
    path = os.path.abspath(os.path.join(model_dir, f"{name}_{epoch}"))
    ckpt_lib.write(path, _state_dict(state))
    return path


def latest_checkpoint_path(
    name: str, model_dir: str = "./model"
) -> str | None:
    """Highest-epoch ``{model_dir}/{name}_<epoch>`` checkpoint, or None
    (the save layout of :func:`save_checkpoint` / the reference's
    ``./model/*.pdparams`` naming, ``PAPC/train.py:118-120``)."""
    import re

    best, best_epoch = None, -1
    if not os.path.isdir(model_dir):
        return None
    for entry in os.listdir(model_dir):
        m = re.fullmatch(re.escape(name) + r"_(\d+)", entry)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(model_dir, entry)
    return best


def restore_checkpoint(state: TrainState, path: str) -> TrainState:
    return state.replace(**ckpt_lib.read(path, _state_dict(state)))


def _as_batch_dict(spec: ModelSpec, raw) -> dict:
    """Adapt a loader Batch namedtuple / dict to the trainer batch dict."""
    if isinstance(raw, dict):
        return raw
    return {k: v for k, v in raw._asdict().items() if v is not None}


def evaluate(
    model_name: str = "pointnet_basic",
    mode: str = "clas",
    max_point: int = 1024,
    num_classes: int = 16,
    num_parts: int = 50,
    batchsize: int = 32,
    path: str = "./dataset/",
    checkpoint_path: str | None = None,
    split: str = "test",
    make_loader: Callable | None = None,
    model_dir: str = "./model",
    log: Callable[[str], None] = print,
):
    """Evaluate a zoo checkpoint on a ShapeNet split (the reference has
    no offline eval entry for Stack A — its 'test' loaders exist but are
    never driven; this is the working one)."""
    spec = init_model(model_name, mode, num_classes, num_parts, max_point)
    if make_loader is None:
        from papc_tpu.data.dispatch import make_dataloader

        def make_loader(mode2):
            return make_dataloader(
                model_name, max_point, batchsize, path, mode, mode2
            )

    loader = make_loader(split)
    rng = jax.random.PRNGKey(0)
    first = _as_batch_dict(spec, next(iter(loader())))
    state = create_train_state(spec, rng, first)
    if checkpoint_path is None:
        # auto-discover the latest trainer checkpoint — silently scoring
        # a freshly initialized model is a footgun, not an evaluation
        checkpoint_path = latest_checkpoint_path(model_name, model_dir)
        if checkpoint_path is None:
            raise FileNotFoundError(
                f"no {model_dir}/{model_name}_<epoch> checkpoint found "
                "— train first or pass --checkpoint explicitly"
            )
        log(f"eval: restoring latest checkpoint {checkpoint_path}")
    state = restore_checkpoint(state, checkpoint_path)
    _, eval_step = make_train_step(spec, num_parts)
    losses, metrics, weights = [], [], []
    for raw in loader():
        batch = _as_batch_dict(spec, raw)
        loss, metric = eval_step(state, batch)
        w = float(np.sum(batch["mask"]))
        losses.append(float(loss) * w)
        metrics.append(float(metric) * w)
        weights.append(w)
    total = max(sum(weights), 1.0)
    name = "miou" if mode == "seg" else "accuracy"
    result = {
        "loss": sum(losses) / total,
        name: sum(metrics) / total,
        "num_samples": int(total),
    }
    log(f"eval[{split}]: " + ", ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()
    ))
    return result


def train(
    model_name: str = "pointnet_basic",
    mode: str = "clas",
    max_point: int = 1024,
    num_classes: int = 16,
    num_parts: int = 50,
    learning_rate: float = 0.001,
    weight_decay: float = 0.001,
    epoch_num: int = 10,
    batchsize: int = 32,
    info_iter: int = 40,
    save_iter: int = 2,
    path: str = "./dataset/",
    model_dir: str = "./model/",
    seed: int = 0,
    precision: str = "fp32",
    scan_steps: int = 1,
    make_loader: Callable | None = None,
    log: Callable[[str], None] = print,
):
    """Train a zoo model — the reference's top-level entry point
    (``PAPC/train.py:78-138``), rebuilt.

    ``make_loader(mode2)`` may inject a custom loader factory (used by
    tests and by the kd/voxel data paths); default is the ShapeNet h5
    pipeline.
    """
    from papc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    spec = init_model(model_name, mode, num_classes, num_parts, max_point)

    if make_loader is None:
        from papc_tpu.data.dispatch import make_dataloader

        def make_loader(mode2):
            return make_dataloader(
                model_name, max_point, batchsize, path, mode, mode2
            )

    train_loader = make_loader("train")
    val_loader = make_loader("val")

    mesh = make_mesh_for_batch(batchsize)
    rng = jax.random.PRNGKey(seed)

    first = _as_batch_dict(spec, next(iter(train_loader())))
    state = create_train_state(
        spec, rng, first, learning_rate, weight_decay
    )
    state = replicate(mesh, state)
    train_step, eval_step = make_train_step(spec, num_parts, precision)
    scan_step = (
        make_scan_train_step(spec, scan_steps, num_parts, precision)
        if scan_steps > 1
        else None
    )

    from papc_tpu.data.prefetch import prefetch_to_device
    from papc_tpu.parallel.mesh import data_sharding, stacked_data_sharding

    def _stacked_epoch_iter():
        """Group K host batches per scanned call; leftovers (< K at
        epoch end) fall back to single stepping."""
        buf = []
        for raw in train_loader():
            buf.append(_as_batch_dict(spec, raw))
            if len(buf) == scan_steps:
                yield ("scan", stack_batches(buf))
                buf = []
        for b in buf:
            yield ("single", b)

    history = []
    step_count = 0
    name = "miou" if mode == "seg" else "accuracy"
    for epoch in range(epoch_num):
        log("=" * 35 + "train" + "=" * 43)
        t0 = time.time()
        if scan_step is not None:
            batches = prefetch_to_device(
                _stacked_epoch_iter(),
                size=2,
                sharding=lambda kb: (
                    stacked_data_sharding(mesh)
                    if kb[0] == "scan"
                    else data_sharding(mesh)
                ),
            )
            for kind, batch in batches:
                rng, drop_rng = jax.random.split(rng)
                if kind == "scan":
                    state, losses, metrics = scan_step(
                        state, batch, drop_rng
                    )
                    loss, metric = losses[-1], metrics[-1]
                    n_done = scan_steps
                else:
                    state, loss, metric = train_step(
                        state, batch, drop_rng
                    )
                    n_done = 1
                if (step_count // scan_steps) % max(
                    info_iter // scan_steps, 1
                ) == 0:
                    log(
                        f"epoch: {epoch}, batch_id: {step_count}, "
                        f"loss is: [{float(loss):.6f}], "
                        f"{name} is: [{float(metric):.6f}]"
                    )
                step_count += n_done
        else:
            batches = prefetch_to_device(
                train_loader(),
                size=2,
                transform=lambda raw: _as_batch_dict(spec, raw),
                sharding=data_sharding(mesh),
            )
            for batch_id, batch in enumerate(batches):
                rng, drop_rng = jax.random.split(rng)
                state, loss, metric = train_step(state, batch, drop_rng)
                if batch_id % info_iter == 0:
                    log(
                        f"epoch: {epoch}, batch_id: {batch_id}, "
                        f"loss is: [{float(loss):.6f}], "
                        f"{name} is: [{float(metric):.6f}]"
                    )
                step_count += 1
        epoch_time = time.time() - t0

        if epoch % save_iter == 0:
            save_checkpoint(state, model_dir, model_name, epoch)

        # validation
        log("=" * 35 + "val" + "=" * 45)
        v_losses, v_metrics = [], []
        for batch_id, raw in enumerate(val_loader()):
            batch = shard_batch(mesh, _as_batch_dict(spec, raw))
            loss, metric = eval_step(state, batch)
            v_losses.append(float(loss))
            v_metrics.append(float(metric))
            if batch_id % info_iter == 0:
                name = "miou" if mode == "seg" else "accuracy"
                log(
                    f"epoch: {epoch}, batch_id: {batch_id}, "
                    f"loss is: [{float(loss):.6f}], "
                    f"{name} is: [{float(metric):.6f}]"
                )
        # multi-host: each process evaluated its shard — reduce over DCN
        from papc_tpu.parallel.distributed import all_mean

        history.append(
            {
                "epoch": epoch,
                "epoch_time": epoch_time,
                # weight by the TRUE local batch count: a process with an
                # empty shard must contribute weight 0, not a 0-valued
                # mean with weight 1 (which would bias the cross-host
                # mean toward zero)
                "val_loss": all_mean(
                    sum(v_losses) / max(len(v_losses), 1),
                    weight=len(v_losses),
                ),
                "val_metric": all_mean(
                    sum(v_metrics) / max(len(v_metrics), 1),
                    weight=len(v_metrics),
                ),
            }
        )
    return state, history
