"""A small module layer for the model zoo.

The models are written in the Flax-linen style — dataclass modules with
`setup` or `@compact` `__call__`, `init(rng, ...) -> {"params": tree}`
and `apply(variables, ...)` — and build the same parameter tree Flax
would, key for key and shape for shape (`Conv_0`, `Dense_0`, explicit
names, setup attribute names). Checkpoints and the sharding rules in
`dist/sharding_rules.py` key on those paths.

Parameters are created where a module first asks for them while
`init` runs, and looked up by path under `apply`. Every parameter's
initial value is drawn from the init key folded with a hash of its
path, so it does not depend on the order in which modules run.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

lecun_normal = jax.nn.initializers.lecun_normal
zeros = jax.nn.initializers.zeros

_running = threading.local()


def _stack() -> list:
    if not hasattr(_running, "stack"):
        _running.stack = []
    return _running.stack


class _Scope:
    """One module's view of the parameter tree."""

    def __init__(self, params: dict, rng, initializing: bool, path=()):
        self.params = params
        self.rng = rng
        self.initializing = initializing
        self.path = path

    def child(self, name: str) -> "_Scope":
        if self.initializing:
            sub = self.params.setdefault(name, {})
        elif name in self.params:
            sub = self.params[name]
        else:
            raise KeyError(
                f"no parameters for module '{'/'.join(self.path + (name,))}'"
            )
        return _Scope(sub, self.rng, self.initializing, self.path + (name,))

    def param(self, name: str, init_fn: Callable, *init_args):
        if name in self.params:
            return self.params[name]
        if not self.initializing:
            raise KeyError(
                f"no parameter '{'/'.join(self.path + (name,))}'"
            )
        tag = zlib.crc32("/".join(self.path + (name,)).encode())
        value = init_fn(jax.random.fold_in(self.rng, tag), *init_args)
        self.params[name] = value
        return value


def compact(fn: Callable) -> Callable:
    """Mark a method whose submodules are declared inline (auto-named
    `<Class>_<n>` unless given a name)."""
    fn._compact = True
    return fn


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._bind()
        stack = _stack()
        stack.append(self)
        mode = self._mode
        try:
            self._run_setup()
            if getattr(fn, "_compact", False):
                self._mode = "compact"
                self._counters = {}
            return fn(self, *args, **kwargs)
        finally:
            self._mode = mode
            stack.pop()

    return wrapped


def _submodules(value) -> list:
    if isinstance(value, Module):
        return [value]
    if isinstance(value, (list, tuple)):
        return [v for v in value if isinstance(v, Module)]
    return []


class Module:
    """Base class: subclasses are dataclasses of their hyperparameters,
    plus a keyword-only `name`."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, repr=False, eq=False)
        field_init = cls.__init__

        def __init__(self, *args, name: str | None = None, **kw):
            field_init(self, *args, **kw)
            object.__setattr__(self, "name", name)
            object.__setattr__(self, "_scope", None)
            object.__setattr__(self, "_mode", None)
            object.__setattr__(self, "_counters", {})
            object.__setattr__(self, "_setup_done", False)
            stack = _stack()
            parent = stack[-1] if stack else None
            object.__setattr__(self, "_parent", parent)
            if parent is not None and name is None and parent._mode == "compact":
                object.__setattr__(self, "name", parent._auto_name(cls.__name__))

        cls.__init__ = __init__
        if "__call__" in cls.__dict__:
            cls.__call__ = _wrap_method(cls.__dict__["__call__"])

    def __setattr__(self, key: str, value: Any) -> None:
        if self.__dict__.get("_mode") == "setup":
            subs = _submodules(value)
            single = isinstance(value, Module)
            for i, m in enumerate(subs):
                if m.name is None:
                    object.__setattr__(m, "name", key if single else f"{key}_{i}")
        object.__setattr__(self, key, value)

    def _auto_name(self, cls_name: str) -> str:
        n = self._counters.get(cls_name, 0)
        self._counters[cls_name] = n + 1
        return f"{cls_name}_{n}"

    def _bind(self) -> None:
        if self._scope is not None:
            return
        if self._parent is None or self._parent._scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is unbound: call it through "
                "init/apply or from inside another module"
            )
        object.__setattr__(self, "_scope", self._parent._scope.child(self.name))

    def _run_setup(self) -> None:
        if self._setup_done:
            return
        object.__setattr__(self, "_setup_done", True)
        setup = getattr(self, "setup", None)
        if setup is not None:
            self._mode = "setup"
            try:
                setup()
            finally:
                self._mode = None

    def _bound_copy(self, scope: _Scope) -> "Module":
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        m = type(self)(**fields)
        object.__setattr__(m, "_parent", None)
        object.__setattr__(m, "_scope", scope)
        return m

    # --- public API ---------------------------------------------------

    def init(self, rng, *args, **kwargs) -> dict:
        """Run the module once, creating its parameters from `rng`.
        Returns {"params": tree}."""
        params: dict = {}
        self._bound_copy(_Scope(params, rng, True))(*args, **kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, **kwargs):
        """Run the module with the parameters in variables["params"]."""
        return self._bound_copy(
            _Scope(variables["params"], None, False)
        )(*args, **kwargs)

    def param(self, name: str, init_fn: Callable, *init_args):
        return self._scope.param(name, init_fn, *init_args)

    def is_initializing(self) -> bool:
        return self._scope.initializing

    @property
    def variables(self) -> dict:
        return {"params": self._scope.params}


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv(Module):
    """NHWC convolution with an HWIO kernel and a bias; computes in
    `dtype` (the promoted input/param type when None)."""

    features: int
    kernel_size: tuple = (3, 3)
    strides: Any = 1
    padding: str = "SAME"
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        kernel = self.param(
            "kernel", lecun_normal(),
            tuple(self.kernel_size) + (x.shape[-1], self.features),
            self.param_dtype,
        )
        bias = self.param("bias", zeros, (self.features,), self.param_dtype)
        dt = self.dtype or jnp.result_type(x, kernel, bias)
        y = lax.conv_general_dilated(
            x.astype(dt),
            kernel.astype(dt),
            window_strides=_pair(self.strides),
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return y + bias.astype(dt)


class Dense(Module):
    """Affine map over the last axis."""

    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        kernel = self.param(
            "kernel", lecun_normal(), (x.shape[-1], self.features),
            self.param_dtype,
        )
        bias = self.param("bias", zeros, (self.features,), self.param_dtype)
        dt = self.dtype or jnp.result_type(x, kernel, bias)
        y = lax.dot_general(
            x.astype(dt), kernel.astype(dt),
            (((x.ndim - 1,), (0,)), ((), ())),
        )
        return y + bias.astype(dt)
