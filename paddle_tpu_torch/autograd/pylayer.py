"""PyLayer: a user-defined forward and backward (port of
``paddle_tpu/autograd/pylayer.py``) over ``torch.autograd.Function``.

A subclass writes ``forward(ctx, *args, **kwargs)`` and
``backward(ctx, *grads)`` as staticmethods, Paddle's way: ``backward``
returns one gradient per tensor argument of ``forward`` (non-tensor
arguments get none), and ``ctx`` is a :class:`PyLayerContext`. The
forward runs without recording, as the reference's does under
``no_grad``; integer outputs carry no gradient.
"""
from __future__ import annotations

import torch


class _Saved(tuple):
    """The saved tensors: a tuple that is also callable, so
    ``ctx.saved_tensor`` (the reference's property) and
    ``ctx.saved_tensor()`` (Paddle's method) both give them."""

    def __call__(self):
        return self


class PyLayerContext:
    """Paddle's ctx over torch's: ``save_for_backward``, ``saved_tensor``,
    ``mark_not_inplace``, ``mark_non_differentiable``,
    ``set_materialize_grads``; other attributes set in ``forward`` reach
    ``backward``."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = _Saved()
        self._through_torch = False
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        if self._ctx is not None and all(
                t is None or isinstance(t, torch.Tensor) for t in tensors):
            self._ctx.save_for_backward(*tensors)
            self._through_torch = True
        else:
            self._saved = _Saved(tensors)

    @property
    def saved_tensor(self):
        if self._through_torch:
            return _Saved(self._ctx.saved_tensors)
        return self._saved

    def saved_tensors(self):
        return self.saved_tensor

    def mark_not_inplace(self, *tensors):
        """Nothing to do: torch's in-place marking (``mark_dirty``) is
        opt-in."""

    def mark_non_differentiable(self, *tensors):
        if self._ctx is not None:
            self._ctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value):
        self.materialize_grads = bool(value)
        if self._ctx is not None:
            self._ctx.set_materialize_grads(bool(value))


def _function_of(layer_cls):
    """The ``torch.autograd.Function`` that runs ``layer_cls``'s forward
    and backward (made once a class). Its arguments are the keyword
    arguments' dict, then the positional ones."""
    fn = layer_cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        pctx = ctx.pylayer = PyLayerContext(ctx)
        ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        return layer_cls.forward(pctx, *args, **kwargs)

    def backward(ctx, *grads):
        out = layer_cls.backward(ctx.pylayer, *grads)
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        it = iter(out)
        return (None,) + tuple(next(it, None) if is_t else None
                               for is_t in ctx.tensor_args)

    fn = type(layer_cls.__name__, (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    layer_cls._torch_function = fn
    return fn


class PyLayer:
    """Subclass with ``forward(ctx, ...)`` and ``backward(ctx, *grads)``
    staticmethods; call ``MyLayer.apply(...)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)


__all__ = ["PyLayer", "PyLayerContext"]
