"""A small module system for the network code: the subset of ``flax.linen``
the models use, with the same parameter trees, names and initial values.

Modules are dataclasses. A module constructed inside another module's
``__call__`` becomes its child: it takes the ``name`` it is given (or
``ClassName_<n>``) and its parameters live under that name. ``init`` returns
``{'params': tree}``; ``apply`` runs the network on such a dict and, with
``capture_intermediates=True, mutable=[...]``, also returns every module's
``__call__`` output under ``{'intermediates': ...}``.

Initial values are those flax.linen gives for the same key: a parameter's key
is the root key folded with the SHA-1 of its module path and a per-module
counter. ``tests/test_nn_core.py`` runs the model code under both and holds
the trees, values and outputs equal.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
leaky_relu = jax.nn.leaky_relu

_UNSPECIFIED = object()  # parent not given: take the module being called


class _Stack(threading.local):
    def __init__(self):
        self.modules = []


_CALLING = _Stack()


def _fold_in_path(key, parts) -> jax.Array:
    """flax's ``LazyRng`` fold: SHA-1 of the path strings and counter ints."""
    m = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Frame:
    """State of one ``init`` or ``apply``: the parameter tree, the init key
    (None when applying) and the captured intermediates."""

    def __init__(self, params: dict, key=None, capture: bool = False):
        self.params = params
        self.key = key
        self.capture = capture
        self.intermediates: dict = {}
        self.rng_counts: dict = {}

    def record(self, path, value):
        node = self.intermediates
        for p in path:
            node = node.setdefault(p, {})
        node["__call__"] = node.get("__call__", ()) + (value,)


class _Scope:
    """Where one bound module keeps its parameters."""

    def __init__(self, frame: _Frame, path: tuple):
        self.frame = frame
        self.path = path
        self.autoname: dict = {}
        self.names: set = set()

    def child(self, name: str) -> "_Scope":
        if name in self.names:
            raise ValueError(f"submodule name {name!r} used twice in "
                             f"{'/'.join(self.path) or '<root>'}")
        self.names.add(name)
        return _Scope(self.frame, self.path + (name,))

    def node(self, create: bool) -> Optional[dict]:
        node = self.frame.params
        for p in self.path:
            if p not in node:
                if not create:
                    return None
                node[p] = {}
            node = node[p]
        return node

    def param(self, name: str, init_fn: Callable, *init_args):
        init = self.frame.key is not None
        node = self.node(create=init)
        if node is not None and name in node:
            value = node[name]
            if (init_args and isinstance(init_args[0], tuple)
                    and tuple(jnp.shape(value)) != tuple(init_args[0])):
                raise ValueError(
                    f"parameter {'/'.join(self.path + (name,))} has shape "
                    f"{jnp.shape(value)}, the module needs {init_args[0]}")
            return value
        if not init:
            raise KeyError(f"no parameter {'/'.join(self.path + (name,))}")
        n = self.frame.rng_counts.get(self.path, 0) + 1
        self.frame.rng_counts[self.path] = n
        value = init_fn(_fold_in_path(self.frame.key, self.path + (n,)), *init_args)
        node[name] = value
        return value


def _run(fn, module, args, kwargs):
    scope = module._scope
    scope.autoname.clear()
    scope.names.clear()
    _CALLING.modules.append(module)
    try:
        # the module path names the ops in traces and compiled HLO
        with jax.named_scope(scope.path[-1] if scope.path else type(module).__name__):
            out = fn(module, *args, **kwargs)
    finally:
        _CALLING.modules.pop()
    if scope.frame.capture:
        scope.frame.record(scope.path, out)
    return out


def _checkpointed(fn, module, args, kwargs):
    """Apply ``module`` under ``jax.checkpoint``: its parameters go in as an
    argument, so the backward pass recomputes its activations."""
    if kwargs:
        raise TypeError("a rematerialized module takes positional arguments only")
    path = module._scope.path

    def pure(params, *args):
        tree = params
        for p in reversed(path):
            tree = {p: tree}
        inner = copy.copy(module)
        inner._scope = _Scope(_Frame(tree), path)
        return _run(fn, inner, args, {})

    return jax.checkpoint(pure)(module._scope.node(create=False), *args)


def _bound_call(fn):
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        scope = self._scope
        if scope is None:
            raise RuntimeError(f"{type(self).__name__} is not bound: run it "
                               "through init() or apply()")
        if type(self)._remat and scope.frame.key is None:
            return _checkpointed(fn, self, args, kwargs)
        return _run(fn, self, args, kwargs)

    return call


def compact(fn):
    """Marks ``__call__`` as defining submodules inline (every ``__call__``
    here may; kept so model code reads as flax.linen code)."""
    return fn


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses are dataclasses whose ``__call__`` may build
    submodules and declare parameters with :meth:`param`."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)
    parent: Any = dataclasses.field(default=_UNSPECIFIED, kw_only=True, repr=False)

    _remat = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "__call__" in cls.__dict__:
            cls.__call__ = _bound_call(cls.__dict__["__call__"])
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        self._scope = None
        if self.parent is _UNSPECIFIED:
            self.parent = _CALLING.modules[-1] if _CALLING.modules else None
        if self.parent is None:
            return
        scope = self.parent._scope
        if scope is None:
            raise RuntimeError(f"parent of {type(self).__name__} is not bound")
        if self.name is None:
            prefix = type(self).__name__
            n = scope.autoname.get(prefix, 0)
            scope.autoname[prefix] = n + 1
            self.name = f"{prefix}_{n}"
        self._scope = scope.child(self.name)

    def param(self, name: str, init_fn: Callable, *init_args):
        return self._scope.param(name, init_fn, *init_args)

    def clone(self, **updates) -> "Module":
        updates.setdefault("parent", None)
        return dataclasses.replace(self, **updates)

    def _root(self, frame: _Frame) -> "Module":
        root = copy.copy(self)
        root._scope = _Scope(frame, ())
        return root

    def init(self, rngs, *args, **kwargs) -> dict:
        key = rngs["params"] if isinstance(rngs, dict) else rngs
        frame = _Frame({}, key=key)
        self._root(frame)(*args, **kwargs)
        return {"params": frame.params}

    def apply(self, variables, *args, rngs=None, mutable=False,
              capture_intermediates: bool = False, **kwargs):
        del rngs  # the networks draw no random numbers when applied
        frame = _Frame(variables["params"], capture=capture_intermediates)
        out = self._root(frame)(*args, **kwargs)
        if mutable:
            return out, ({"intermediates": frame.intermediates}
                         if capture_intermediates else {})
        return out


def remat(module_cls):
    """``module_cls`` whose applied ``__call__`` runs under ``jax.checkpoint``
    (init is unchanged, so parameters are the same as without it)."""
    return type(module_cls.__name__, (module_cls,), {"_remat": True})


def _promote(*xs, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def _tuple(v, n: int) -> tuple:
    if v is None:
        v = 1
    return (v,) * n if isinstance(v, int) else tuple(v)


def _padding(padding):
    if isinstance(padding, str):
        return padding
    return [tuple(p) for p in padding]


_NHWC = ("NHWC", "HWIO", "NHWC")


class Dense(Module):
    """y = x @ kernel + bias over the last axis; kernel (in, features)."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init, (jnp.shape(x)[-1], self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class Conv(Module):
    """2-D NHWC convolution; kernel (kh, kw, in, features)."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", self.kernel_init, ks + (x.shape[-1], self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides, len(ks)), _padding(self.padding),
            lhs_dilation=(1,) * len(ks), rhs_dilation=(1,) * len(ks),
            dimension_numbers=_NHWC)
        if bias is not None:
            y = y + bias.reshape((1,) * (y.ndim - 1) + bias.shape)
        return y


class ConvTranspose(Module):
    """2-D NHWC transposed convolution; kernel (kh, kw, in, features)."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = None
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", self.kernel_init, ks + (x.shape[-1], self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.conv_transpose(x, kernel, _tuple(self.strides, len(ks)),
                               _padding(self.padding), rhs_dilation=(1,) * len(ks),
                               transpose_kernel=False)
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class GroupNorm(Module):
    """Group normalization over all but the batch axis, per channel group;
    statistics in at least float32, variance as E[x^2] - E[x]^2."""

    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Any = None
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        channels = x.shape[-1]
        groups = self.num_groups
        if groups <= 0 or channels % groups:
            raise ValueError(f"{groups} groups do not divide {channels} channels")
        size = channels // groups
        stats = jnp.promote_types(x.dtype if self.dtype is None else self.dtype,
                                  jnp.float32)
        xg = x.reshape(x.shape[:-1] + (groups, size)).astype(stats)
        axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
        mu, mu2 = xg.mean(axes), lax.square(xg).mean(axes)
        var = jnp.maximum(0.0, mu2 - lax.square(mu))
        spatial = tuple(range(1, x.ndim - 1))
        mean = jnp.expand_dims(jnp.repeat(mu, size, axis=-1), spatial)
        var = jnp.expand_dims(jnp.repeat(var, size, axis=-1), spatial)
        feature_shape = (1,) * (x.ndim - 1) + (channels,)
        y = x - mean
        mul = lax.rsqrt(var + self.epsilon)
        args = [x]
        if self.use_scale:
            scale = self.param("scale", self.scale_init, (channels,)).reshape(feature_shape)
            mul = mul * scale
            args.append(scale)
        y = y * mul
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (channels,)).reshape(feature_shape)
            y = y + bias
            args.append(bias)
        return jnp.asarray(y, jnp.result_type(*args) if self.dtype is None else self.dtype)


def _pool(x, init, fn, window_shape, strides, padding):
    dims = (1,) + tuple(window_shape) + (1,)
    strides = (1,) + tuple(strides or (1,) * len(window_shape)) + (1,)
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(map(tuple, padding)) + ((0, 0),)
    return lax.reduce_window(x, init, fn, dims, strides, padding)


def max_pool(x, window_shape, strides=None, padding="VALID"):
    return _pool(x, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(x, window_shape, strides=None, padding="VALID"):
    """Window mean, padding counted (flax's ``count_include_pad=True``)."""
    return _pool(x, 0.0, lax.add, window_shape, strides, padding) / np.prod(window_shape)
