"""Serialized model export for serving (StableHLO via ``jax.export``).

Reference analog: the TensorRT-export staging helpers in
``PAPC/models/detect/pointpillars/data/preprocess.py:369-502``
(``voxel_padding``, ``example_to_tensorlist``/``example_to_tensorlist_infer``)
whose whole job is forcing fixed tensor shapes so an inference engine can
be built. In this framework every jitted path is static-shape by
construction, so the equivalent here is a single ``jax.export``
call: the forward function — with the trained variables frozen in as
constants — lowers to portable StableHLO bytes that a serving process
reloads and runs without any model Python.

Artifacts are plain files (``*.stablehlo``) and survive process/version
boundaries per StableHLO's compatibility guarantees — except the
Pallas-Triton kernels in the CUDA lowering (FPS, see
:mod:`papc_tpu.ops.pallas.fps`), whose Triton IR is only guaranteed to
load under the JAX version that wrote it. Each platform's lowering
carries its own branch of ``lax.platform_dependent``, so the CPU
lowering holds no kernel.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import jax
from jax import export as _jexport

DEFAULT_PLATFORMS = ("cuda", "cpu")
# custom-call targets that carry no cross-version compatibility promise
_UNSTABLE_TARGETS = ("__gpu$xla.gpu.triton",)


def _specs_of(args) -> tuple:
    return jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tuple(args)
    )


def export_fn(
    fn: Callable,
    example_args: Sequence,
    *,
    path: str | None = None,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
) -> bytes:
    """Serialize ``jit(fn)(*example_args)`` to StableHLO bytes.

    ``fn`` should close over its trained variables (frozen-graph export —
    the serving analog of a built TensorRT engine). ``example_args`` fix
    the static shapes; only shape/dtype are read. Multi-platform
    lowering (default cuda+cpu) lets one artifact serve on a GPU and in
    CPU integration tests alike.
    """
    exp = _jexport.export(
        jax.jit(fn),
        platforms=list(platforms),
        disabled_checks=[
            _jexport.DisabledSafetyCheck.custom_call(t)
            for t in _UNSTABLE_TARGETS
        ],
    )(*_specs_of(example_args))
    data = exp.serialize()
    if path is not None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return data


def load_exported(path_or_bytes: str | bytes) -> Callable:
    """Reload a serialized artifact as a callable running under jit."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = path_or_bytes
    exp = _jexport.deserialize(data)
    return jax.jit(exp.call)


def export_classifier(
    spec,
    variables,
    *,
    batch_size: int,
    path: str | None = None,
    max_point: int = 1024,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
) -> bytes:
    """Export a Stack-A model's eval-mode forward: points → logits.

    ``spec`` is a :class:`~papc_tpu.models.registry.ModelSpec` with
    ``input_kind == 'points'``; other input kinds (kd/voxel) export via
    :func:`export_fn` with their own example inputs.
    """
    if spec.input_kind != "points":
        raise ValueError(
            "export_classifier covers input_kind='points'; use export_fn "
            f"with explicit example args for {spec.input_kind!r}"
        )
    import jax.numpy as jnp

    def forward(points):
        return spec.model.apply(variables, points, train=False)

    example = jnp.zeros((batch_size, max_point, 3), jnp.float32)
    return export_fn(forward, (example,), path=path, platforms=platforms)


def export_detector_predict(
    predict_step,
    state,
    example_batch: dict,
    *,
    path: str | None = None,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
) -> bytes:
    """Export the full PointPillars inference step (pillars → decoded,
    NMS-filtered boxes/scores/labels) with the train state frozen in.

    ``predict_step`` comes from
    :func:`papc_tpu.detect.train.make_predict_step`; ``example_batch``
    needs the inference keys (voxels/num_points/coordinates/anchors).
    The exported function takes the batch dict as its single argument.
    """

    def forward(batch):
        return predict_step(state, batch)

    return export_fn(forward, (example_batch,), path=path, platforms=platforms)
