"""A small module layer: the subset of ``flax.linen`` this repo uses.

Models are frozen-free dataclasses whose ``@compact`` ``__call__`` creates
child modules, parameters and variables on the fly, exactly as in linen:

* ``Module`` with ``@compact``, ``param``, ``variable``, ``make_rng``,
  ``is_initializing``, and ``init`` / ``apply`` (``mutable=`` returns the
  updated collections beside the output);
* layers ``Dense``, ``Conv``, ``ConvTranspose``, ``BatchNorm``,
  ``GroupNorm``, ``Dropout`` and ``max_pool``, with linen's parameter
  names, shapes, initializers and dtype promotion;
* children are named ``<Class>_<n>`` per parent call unless given a
  ``name``, so variable trees have linen's paths (``Dense_0/kernel``,
  ``BatchNorm_0`` in ``batch_stats``) and checkpoints and parity tests
  carry over.

Random streams follow linen's derivation (the root key folded with the
first four bytes of the SHA-1 of the module path and a per-module draw
counter), so a fresh init draws the same values as linen would.

The activations are ``jax.nn``'s, re-exported here so model code reads
as before.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import types
from typing import Any, Callable, Iterable, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import (  # noqa: F401  re-exported activations
    leaky_relu,
    log_softmax,
    one_hot,
    relu,
    sigmoid,
    softmax,
)

initializers = types.SimpleNamespace(
    lecun_normal=jax.nn.initializers.lecun_normal,
    zeros=jax.nn.initializers.zeros,
    ones=jax.nn.initializers.ones,
    # linen spells the constant initializers as factories as well
    zeros_init=lambda: jax.nn.initializers.zeros,
    ones_init=lambda: jax.nn.initializers.ones,
)


class _State:
    """Variables, rngs and mutability of one ``init``/``apply`` call."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counts: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def get(self, col, path, name):
        d = self.variables.get(col)
        for p in path:
            if d is None:
                return None
            d = d.get(p)
        return None if d is None else d.get(name)

    def put(self, col, path, name, value):
        if not self.is_mutable(col):
            raise ValueError(
                f"collection {col!r} is immutable here; pass "
                f"mutable=[{col!r}] to apply to update "
                f"{'/'.join(path + (name,))}"
            )
        d = self.variables.setdefault(col, {})
        for p in path:
            d = d.setdefault(p, {})
        d[name] = value


class _Frame:
    """One running compact call: the names its children took."""

    def __init__(self, module):
        self.module = module
        self.counts: dict = {}
        self.used: set = set()


_CTX = threading.local()


def _stack() -> list:
    if not hasattr(_CTX, "stack"):
        _CTX.stack = []
    return _CTX.stack


class Variable:
    """A handle on one variable; ``.value`` reads and writes it."""

    def __init__(self, state: _State, col: str, path: tuple, name: str):
        self._state, self._col, self._path, self._name = (
            state, col, path, name,
        )

    @property
    def value(self):
        return self._state.get(self._col, self._path, self._name)

    @value.setter
    def value(self, v):
        self._state.put(self._col, self._path, self._name, v)


@dataclasses.dataclass(eq=True, unsafe_hash=True)
class Module:
    """Base class: subclasses become dataclasses of their attributes."""

    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True)

    def __post_init__(self):
        object.__setattr__(self, "_state", None)
        object.__setattr__(self, "_path", ())
        stack = _stack()
        if not stack:
            return
        frame = stack[-1]
        name = self.name
        if name is None:
            prefix = type(self).__name__
            n = frame.counts.get(prefix, 0)
            frame.counts[prefix] = n + 1
            name = f"{prefix}_{n}"
        if name in frame.used:
            raise ValueError(
                f"duplicate submodule name {name!r} in "
                f"{type(frame.module).__name__}"
            )
        frame.used.add(name)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_state", frame.module._state)
        object.__setattr__(self, "_path", frame.module._path + (name,))

    # -- variables -----------------------------------------------------

    def _bound(self) -> _State:
        if self._state is None:
            raise ValueError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply or from a parent's compact method"
            )
        return self._state

    def is_initializing(self) -> bool:
        return self._bound().initializing

    def make_rng(self, name: str) -> jax.Array:
        state = self._bound()
        if name not in state.rngs:
            raise ValueError(f"no {name!r} rng was passed to init/apply")
        key = (self._path, name)
        n = state.rng_counts.get(key, 0) + 1
        state.rng_counts[key] = n
        h = hashlib.sha1()
        for p in self._path:
            h.update(p.encode("utf-8"))
        h.update(n.to_bytes((n.bit_length() + 7) // 8, byteorder="big"))
        word = int.from_bytes(h.digest()[:4], byteorder="big")
        return jax.random.fold_in(state.rngs[name], jnp.uint32(word))

    def variable(self, col: str, name: str, init_fn=None, *args):
        state = self._bound()
        if state.get(col, self._path, name) is None:
            if init_fn is None or not state.is_mutable(col):
                raise ValueError(
                    f"variable {col}/{'/'.join(self._path + (name,))} "
                    "is missing"
                )
            state.put(col, self._path, name, init_fn(*args))
        return Variable(state, col, self._path, name)

    def param(self, name: str, init_fn: Callable, *args):
        state = self._bound()
        value = state.get("params", self._path, name)
        if value is None:
            if not state.initializing:
                raise ValueError(
                    f"parameter {'/'.join(self._path + (name,))} is missing"
                )
            value = init_fn(self.make_rng("params"), *args)
            state.put("params", self._path, name, value)
        return value

    # -- entry points --------------------------------------------------

    def _run(self, state: _State, args, kwargs):
        root = dataclasses.replace(self)
        object.__setattr__(root, "_state", state)
        return root(*args, **kwargs)

    def init(self, rngs, *args, **kwargs) -> dict:
        """Create every variable; returns ``{collection: tree}``."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        state = _State({}, rngs, True, True)
        self._run(state, args, kwargs)
        return state.variables

    def apply(self, variables: dict, *args, rngs=None, mutable=False,
              **kwargs):
        """Run with ``variables``; with ``mutable`` (a collection name,
        a list of them, or True) returns ``(out, updated collections)``."""
        if isinstance(mutable, str):
            mutable = [mutable]
        cols = (
            set(variables) if mutable is True else set(mutable or ())
        )
        own = {
            k: (_copy_tree(v) if k in cols else v)
            for k, v in variables.items()
        }
        state = _State(own, dict(rngs or {}), mutable or (), False)
        out = self._run(state, args, kwargs)
        if not mutable:
            return out
        return out, {c: own.get(c, {}) for c in sorted(cols)}


def _copy_tree(d):
    return {k: _copy_tree(v) for k, v in d.items()} if isinstance(
        d, dict
    ) else d


def compact(fn):
    """Mark a method whose body creates submodules and variables."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._bound()
        stack = _stack()
        stack.append(_Frame(self))
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


def _promote(*args):
    dtype = jnp.result_type(*[a for a in args if a is not None])
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


def _tuple(v, rank: int) -> tuple:
    return (v,) * rank if isinstance(v, int) else tuple(v)


def _padding(padding, rank: int):
    if isinstance(padding, str):
        return padding
    if isinstance(padding, int):
        return [(padding, padding)] * rank
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def _conv_dims(ndim: int) -> lax.ConvDimensionNumbers:
    lhs = (0, ndim - 1) + tuple(range(1, ndim - 1))
    rhs = (ndim - 1, ndim - 2) + tuple(range(0, ndim - 2))
    return lax.ConvDimensionNumbers(lhs, rhs, lhs)


def _add_bias(y, bias):
    if bias is None:
        return y
    return y + jnp.reshape(bias, (1,) * (y.ndim - 1) + bias.shape)


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis."""

    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features)
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,))
            if self.use_bias else None
        )
        x, kernel, bias = _promote(x, kernel, bias)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return _add_bias(y, bias)


class _ConvBase(Module):
    features: int
    kernel_size: Sequence[int]
    strides: int | Sequence[int] = 1
    padding: Any = "SAME"
    use_bias: bool = True

    def _params(self, x):
        ks = tuple(self.kernel_size)
        unbatched = x.ndim == len(ks) + 1
        if unbatched:
            x = x[None]
        kernel = self.param(
            "kernel", initializers.lecun_normal(),
            ks + (x.shape[-1], self.features),
        )
        bias = (
            self.param("bias", initializers.zeros, (self.features,))
            if self.use_bias else None
        )
        x, kernel, bias = _promote(x, kernel, bias)
        return x, kernel, bias, unbatched


class Conv(_ConvBase):
    """N-d convolution over channel-last inputs (``lax.conv_general_dilated``)."""

    @compact
    def __call__(self, x):
        x, kernel, bias, unbatched = self._params(x)
        rank = kernel.ndim - 2
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides, rank),
            _padding(self.padding, rank),
            dimension_numbers=_conv_dims(x.ndim),
        )
        y = _add_bias(y, bias)
        return y[0] if unbatched else y


class ConvTranspose(_ConvBase):
    """N-d transposed convolution (``lax.conv_transpose``)."""

    @compact
    def __call__(self, x):
        x, kernel, bias, unbatched = self._params(x)
        rank = kernel.ndim - 2
        y = lax.conv_transpose(
            x, kernel, _tuple(self.strides, rank),
            _padding(self.padding, rank),
        )
        y = _add_bias(y, bias)
        return y[0] if unbatched else y


def _stats(x, axes, dtype):
    """Mean and fast variance ``E[x²] − E[x]²`` (clipped at 0), in at
    least float32."""
    dtype = jnp.promote_types(
        jnp.result_type(x) if dtype is None else dtype, jnp.float32
    )
    x = x.astype(dtype)
    # square before the means, as linen does: the order of the uses of
    # x fixes the order its gradient contributions are summed in
    sq = lax.square(x)
    mean, mean2 = x.mean(axes), sq.mean(axes)
    return mean, jnp.maximum(0.0, mean2 - lax.square(mean))


def _normalize(mdl, x, mean, var, reduction_axes, epsilon, dtype):
    """``(x - mean) * rsqrt(var + eps) * scale + bias``, in linen's
    operation order (so gradients round the same way)."""
    feat = x.shape[-1]
    shape = (1,) * (x.ndim - 1) + (feat,)
    mean = jnp.expand_dims(mean, reduction_axes)
    var = jnp.expand_dims(var, reduction_axes)
    scale = mdl.param("scale", initializers.ones, (feat,))
    bias = mdl.param("bias", initializers.zeros, (feat,))
    y = x - mean
    mul = lax.rsqrt(var + epsilon)
    mul = mul * scale.reshape(shape)
    y = y * mul
    y = y + bias.reshape(shape)
    if dtype is None:
        dtype = jnp.result_type(x, scale, bias)
    return jnp.asarray(y, dtype)


class BatchNorm(Module):
    """Batch normalization over every axis but the last, with running
    averages in the ``batch_stats`` collection."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Any = None  # output dtype; None promotes with the f32 params

    @compact
    def __call__(self, x):
        axes = tuple(range(x.ndim - 1))
        feat = (x.shape[-1],)
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros(feat, jnp.float32)
        )
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones(feat, jnp.float32)
        )
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean, var = _stats(x, axes, self.dtype)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        return _normalize(self, x, mean, var, axes, self.epsilon,
                          self.dtype)


class GroupNorm(Module):
    """Group normalization over the channel groups of each example."""

    num_groups: int = 32
    epsilon: float = 1e-6

    @compact
    def __call__(self, x):
        c = x.shape[-1]
        if self.num_groups <= 0 or c % self.num_groups:
            raise ValueError(
                f"{self.num_groups} groups do not divide {c} channels"
            )
        size = c // self.num_groups
        spatial = tuple(range(1, x.ndim - 1))
        grouped = x.reshape(x.shape[:-1] + (self.num_groups, size))
        mean, var = _stats(grouped, spatial + (grouped.ndim - 1,), None)
        mean = jnp.repeat(mean, size, axis=-1)
        var = jnp.repeat(var, size, axis=-1)
        return _normalize(self, x, mean, var, spatial, self.epsilon, None)


class Dropout(Module):
    """Inverted dropout drawing from the ``dropout`` rng."""

    rate: float
    deterministic: bool = False

    @compact
    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))


def max_pool(x, window_shape: Iterable[int], strides=None):
    """Max over (VALID) windows of the spatial axes of a channel-last
    input."""
    window = tuple(window_shape)
    strides = tuple(strides) if strides is not None else (1,) * len(window)
    unbatched = x.ndim == len(window) + 1
    if unbatched:
        x = x[None]
    y = lax.reduce_window(
        x, -jnp.inf, lax.max, (1,) + window + (1,),
        (1,) + strides + (1,), "VALID",
    )
    return y[0] if unbatched else y
