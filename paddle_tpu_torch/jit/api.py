"""@paddle.jit.to_static on ``torch.compile`` (port of
``paddle_tpu/jit/api.py``).

The reference's ``to_static`` is its tracer and compiler: ``jax.jit`` over
the eager op layer, one program per input spec (``_spec_key``), spliced
into its tape as one op. Here dynamo is the tracer (a bytecode tracer like
Paddle's SOT) and inductor the fusing compiler, and torch's autograd
differentiates the compiled region. :class:`StaticFunction` keeps the
reference's spec key (the training flag; each tensor's shape, dtype and
``stop_gradient``; other arguments by value, or by identity where they
cannot be hashed) and one ``torch.compile(..., dynamic=False)`` object a
key.

The counters of :data:`METRICS` (kept here until ``profiler/`` is
ported) map onto the reference's ``_jit_metrics`` (``:37``):

* ``hit`` and ``miss``: spec-cache lookups, counted where the reference
  counts them;
* ``compile_s``: the seconds of each miss's call (trace, compile and the
  first run), the reference's ``paddle_jit_compile_seconds``;
* ``breaks``: dynamo's graph breaks during a call. The reference breaks a
  trace on data-dependent Python and, after a second break, latches the
  spec to eager (``:396-422``); dynamo splits the graph at the break and
  runs the Python between the pieces eagerly, so the reference's
  ``fallback`` counter has no counterpart. With ``full_graph=True``
  (``fullgraph=True``) a break raises;
* ``recompiles``: graphs dynamo compiled on a spec-cache hit, where one of
  its guards failed (for instance the AMP state changed, ROADMAP C35).

Custom ops stay opaque inside a compiled region: flash attention's B1,
B2 and B3 (``ops/flash_attention.py``) are ``torch.library`` ops, so a
compiled Llama forward launches the hand-written kernels and never
PyTorch's own attention.
"""
from __future__ import annotations

import copy
import functools
import os
import time
import types

import numpy as np
import torch

from ..framework import dtype as dtypes

_static_mode = [False]          # paddle.enable_static's flag

#: the spec cache's counters (see the module's docstring)
METRICS = {"hit": 0, "miss": 0, "breaks": 0, "recompiles": 0,
           "compile_s": []}


def reset_metrics():
    METRICS.update(hit=0, miss=0, breaks=0, recompiles=0, compile_s=[])


def _dynamo_counts():
    """(graph breaks, graphs compiled) so far in this process, from
    dynamo's counters (its releases count breaks under ``graph_break`` or
    ``unimplemented``)."""
    from torch._dynamo.utils import counters
    return (max(sum(counters["graph_break"].values()),
                sum(counters["unimplemented"].values())),
            counters["stats"]["unique_graphs"])


def enable_persistent_cache(path=None):
    """Keep inductor's compiled graphs in ``path`` across processes (its
    FX graph cache under ``TORCHINDUCTOR_CACHE_DIR``, the variable
    inductor reads for its cache directory). ``None`` leaves the cache as
    it is and returns False; returns True once set."""
    if not path:
        return False
    path = os.path.abspath(str(path))
    os.makedirs(path, exist_ok=True)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = path
    import torch._inductor.config as inductor_config
    inductor_config.fx_graph_cache = True
    return True


def enable_static():
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def in_dynamic_mode():
    return not _static_mode[0]


def in_to_static_mode():
    """True while dynamo traces (inside a compiled region's trace)."""
    return torch.compiler.is_compiling()


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtypes.convert_dtype(dtype) if dtype is not None \
            else None
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)


def _leaves(tree):
    """The leaves of nested lists, tuples and dicts (dicts by sorted
    key), as ``jax.tree.leaves`` orders them."""
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _spec_key(args, kwargs, training):
    """The reference's cache key, and the objects keyed by identity (the
    cache entry keeps them alive, so their ids cannot be recycled)."""
    parts = [bool(training)]
    pinned = []
    for a in _leaves((list(args), kwargs)):
        if isinstance(a, torch.Tensor):
            parts.append(("T", tuple(a.shape), str(a.dtype),
                          not a.requires_grad))
        elif isinstance(a, (int, float, str, bool, bytes, type(None))):
            parts.append(a)
        elif isinstance(a, np.ndarray):
            parts.append(("A", a.shape, str(a.dtype), a.tobytes()))
        else:
            try:
                hash(a)
            except TypeError:
                parts.append(("O", id(a)))
                pinned.append(a)
            else:
                parts.append(("H", type(a).__qualname__, a))
    return tuple(parts), pinned


def _is_layer(obj):
    return isinstance(obj, torch.nn.Module)


class StaticFunction:
    """The callable ``to_static`` makes: one compiled program a spec."""

    def __init__(self, function, input_spec=None, instance=None,
                 full_graph=False, backend=None):
        self._orig_fn = function
        self._input_spec = input_spec
        self._instance = instance     # set for a decorated unbound method
        self._full_graph = bool(full_graph)
        self._backend = backend or "inductor"
        self._cache = {}
        functools.update_wrapper(self, function)

    def _bind(self, instance):
        return StaticFunction(self._orig_fn, self._input_spec,
                              instance=instance, full_graph=self._full_graph,
                              backend=self._backend)

    def __get__(self, instance, owner):
        """The function bound to ``instance``, with its own compiled
        programs. It is kept in the instance's ``__dict__``, so it lives
        as long as the instance (an object without one gets a new binding,
        and new programs, at every lookup)."""
        if instance is None:
            return self
        slots = getattr(instance, "__dict__", None)
        if slots is None:
            return self._bind(instance)
        key = f"_static_function_{id(self)}"
        bound = slots.get(key)
        if bound is None:
            bound = slots[key] = self._bind(instance)
        return bound

    def __deepcopy__(self, memo):
        """A copy (through a deep copy of its layer or instance) is bound
        to the copies and compiles anew."""
        return StaticFunction(copy.deepcopy(self._orig_fn, memo),
                              self._input_spec,
                              instance=copy.deepcopy(self._instance, memo),
                              full_graph=self._full_graph,
                              backend=self._backend)

    def _layer(self):
        for obj in (self._instance, self._orig_fn,
                    getattr(self._orig_fn, "__self__", None)):
            if _is_layer(obj):
                return obj
        return None

    def _target(self):
        """The eager callable the compiled program traces."""
        if self._instance is not None:
            return types.MethodType(self._orig_fn, self._instance)
        return self._orig_fn

    def _call_eager(self, *args, **kwargs):
        return self._target()(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        layer = self._layer()
        training = layer.training if layer is not None else True
        key, pinned = _spec_key(args, kwargs, training)
        entry = self._cache.get(key)
        breaks0, graphs0 = _dynamo_counts()
        t0 = time.perf_counter()
        if entry is None:
            METRICS["miss"] += 1
            entry = {"compiled": torch.compile(
                self._target(), dynamic=False, fullgraph=self._full_graph,
                backend=self._backend), "pinned": pinned}
            self._cache[key] = entry
            miss = True
        else:
            METRICS["hit"] += 1
            miss = False
        try:
            out = entry["compiled"](*args, **kwargs)
        except torch._dynamo.exc.Unsupported:
            METRICS["breaks"] += 1       # full_graph: a break raises
            raise
        breaks1, graphs1 = _dynamo_counts()
        METRICS["breaks"] += breaks1 - breaks0
        if miss:
            METRICS["compile_s"].append(time.perf_counter() - t0)
        else:
            METRICS["recompiles"] += graphs1 - graphs0
        return out

    @property
    def code(self):
        import inspect
        try:
            return inspect.getsource(self._orig_fn)
        except (OSError, TypeError):
            return "<source unavailable>"

    def rollback(self):
        return self._orig_fn


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=None, **kwargs):
    """@paddle.jit.to_static, as a decorator or a function, on a ``Layer``
    (its ``forward`` becomes the compiled one; ``_static_forward`` and
    ``_dygraph_forward`` keep both), a function or a bound method.
    ``full_graph=True`` makes a graph break an error; ``backend`` names a
    ``torch.compile`` backend (inductor by default)."""

    def decorate(fn):
        if _is_layer(fn):
            orig_forward = fn.forward
            sf = StaticFunction(orig_forward, input_spec,
                                full_graph=full_graph, backend=backend)
            fn._static_forward = sf
            fn._dygraph_forward = orig_forward
            fn.forward = sf
            return fn
        return StaticFunction(fn, input_spec, full_graph=full_graph,
                              backend=backend)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """``fn`` runs eagerly inside a compiled region (dynamo does not trace
    it: ``torch.compiler.disable``)."""
    fn._not_to_static = True
    out = torch.compiler.disable(fn)
    out._not_to_static = True
    return out


def ignore_module(modules):
    """Accepted, as in the reference; nothing to do."""


def enable_to_static(flag=True):
    """Accepted, as in the reference; nothing to do."""


__all__ = ["to_static", "not_to_static", "ignore_module", "StaticFunction",
           "InputSpec", "enable_static", "disable_static", "in_dynamic_mode",
           "in_to_static_mode", "enable_to_static", "enable_persistent_cache",
           "METRICS", "reset_metrics"]
