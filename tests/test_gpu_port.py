"""What the GPU port relies on, checked on the CPU: the compile-cache
rule, export for CUDA, CPU-only data workers, the refusal of a non-GPU
platform by the card checks, the plain SA-MLP against a numpy oracle, and
``.npz`` checkpoints."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


# -- compile cache -----------------------------------------------------------

def test_cache_obeys_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands and
    nothing else is configured."""
    from papc_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.enable_persistent_cache() == str(tmp_path / "c")
    assert calls == []


def test_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    from papc_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_persistent_cache()
    assert got == str(ROOT / ".jax_cache") == cache.CACHE_DIR
    assert calls == [("jax_compilation_cache_dir", got)]
    assert os.path.isdir(got)


# -- export --------------------------------------------------------------------

def test_export_default_platforms_lower_for_cuda(tmp_path):
    """The default export targets CUDA and CPU: the CUDA lowering carries
    the Triton FPS kernel, and the artifact still runs here (CPU branch)."""
    from jax import export as jexport

    from papc_tpu import export as ex
    from papc_tpu.models import init_model

    assert ex.DEFAULT_PLATFORMS == ("cuda", "cpu")
    spec = init_model("pointnet2_ssg", "clas", num_classes=4)
    spec = spec.__class__(
        model=spec.model.__class__(
            num_classes=4, npoints=(16, 8), nsamples=(8, 8)
        ),
        input_kind=spec.input_kind, mode=spec.mode,
    )
    pts = jnp.asarray(np.random.RandomState(0).randn(2, 32, 3), jnp.float32)
    variables = spec.model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        pts, train=False,
    )
    data = ex.export_classifier(spec, variables, batch_size=2, max_point=32)
    exp = jexport.deserialize(data)
    assert tuple(exp.platforms) == ("cuda", "cpu")
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()
    np.testing.assert_allclose(
        np.asarray(exp.call(pts)),
        np.asarray(spec.model.apply(variables, pts, train=False)),
        rtol=1e-5, atol=1e-5,
    )


# -- data workers --------------------------------------------------------------

class _EnvDataset:
    """Reports the JAX platform setting a worker process sees."""

    def set_epoch(self, epoch):
        pass

    def __getitem__(self, idx):
        return os.environ.get("JAX_PLATFORMS")


def test_workers_run_cpu_only(monkeypatch):
    """Spawned workers never open the GPU; the parent's setting comes
    back when the pool closes."""
    from papc_tpu.data.workers import SamplePool

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    with SamplePool(_EnvDataset(), 1) as pool:
        assert list(pool.imap(0, [0, 1])) == ["cpu", "cpu"]
        assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert os.environ["JAX_PLATFORMS"] == "cuda"


# -- card checks refuse other platforms -----------------------------------------

@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_card_checks_refuse_cpu(script, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / script)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "not 'gpu'" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo beside it the script cannot pass."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and '"ok"' not in out.stdout


# -- plain SA-MLP vs numpy ---------------------------------------------------

def _pointmlp_np(x, params, stats, train, eps=1e-5):
    h = x.astype(np.float64)
    for i in range(sum(k.startswith("Dense_") for k in params)):
        d, bn = params[f"Dense_{i}"], params[f"BatchNorm_{i}"]
        h = h @ np.asarray(d["kernel"], np.float64) + np.asarray(d["bias"])
        if train:
            axes = tuple(range(h.ndim - 1))
            mean, var = h.mean(axes), h.var(axes)
        else:
            mean = np.asarray(stats[f"BatchNorm_{i}"]["mean"], np.float64)
            var = np.asarray(stats[f"BatchNorm_{i}"]["var"], np.float64)
        h = (h - mean) / np.sqrt(var + eps) * np.asarray(bn["scale"])
        h = np.maximum(h + np.asarray(bn["bias"]), 0.0)
    return h.max(axis=2)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pointmlp_matches_numpy(train, dtype):
    """The SA shared MLP (Dense→BN→ReLU ×3, max over K) in f32 and bf16,
    with batch and running statistics, against a float64 oracle."""
    from papc_tpu.nn.layers import PointMLP
    from papc_tpu.train.precision import cast_floating

    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 16, 6).astype(np.float32)
    mlp = PointMLP((16, 16, 32), pool_max=True)
    v = mlp.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.rand(*a.shape) + 0.5, a.dtype),
        v["batch_stats"],
    )
    params, xin = v["params"], jnp.asarray(x)
    if dtype == "bfloat16":
        params = cast_floating(params, jnp.bfloat16)
        xin = xin.astype(jnp.bfloat16)
    out = mlp.apply({"params": params, "batch_stats": stats}, xin,
                    train=train, mutable=["batch_stats"])[0]
    want = _pointmlp_np(x, jax.device_get(v["params"]),
                        jax.device_get(stats), train)
    # f32: reduction order only; bf16: 8-bit mantissas in every
    # activation through three layers
    tol = 1e-4 if dtype == "float32" else 8e-2
    np.testing.assert_allclose(
        np.asarray(out, np.float32), want, rtol=tol, atol=tol
    )


# -- checkpoints ------------------------------------------------------------------

def test_npz_checkpoint_roundtrip_and_checks(tmp_path):
    from papc_tpu.train import checkpoint as ck
    from papc_tpu.train.trainer import make_optimizer

    params = {"Dense_0": {"kernel": jnp.ones((3, 4)),
                          "bias": jnp.arange(4.0)}}
    tree = {"params": params,
            "opt_state": make_optimizer(1e-3, 0.0).init(params),
            "step": 7}
    path = str(tmp_path / "m-7")
    ck.write(path, tree)
    ck.write(path, tree)  # overwriting an existing checkpoint is fine
    assert os.listdir(tmp_path) == ["m-7"]
    back = ck.read(path, jax.tree_util.tree_map(jnp.zeros_like, tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    wrong = {"params": {"Dense_0": {"kernel": jnp.ones((4, 4)),
                                    "bias": jnp.zeros(4)}}}
    with pytest.raises(ValueError, match="shape"):
        ck.read(path, wrong)
    with pytest.raises(KeyError, match="no leaf"):
        ck.read(path, {"other": jnp.zeros(1)})
