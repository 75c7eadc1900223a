"""paddle.autograd (port of ``paddle_tpu/autograd/{__init__,tape,pylayer}.py``:
the public surface) over ``torch.autograd``.

Grad modes are torch's, thread-local as the reference's are
(``tape.py:45-107``): ``no_grad``, ``enable_grad`` and
``set_grad_enabled`` work as context managers and decorators,
``is_grad_enabled`` reads the mode. ``grad`` and ``backward`` keep
Paddle's semantics where they differ from torch's:

* ``allow_unused=False`` raises ``ValueError`` on an input the outputs do
  not reach (the reference's message);
* ``retain_graph=None`` follows ``create_graph``;
* ``no_grad_vars`` cuts those tensors: no gradient flows back through
  them.

``jacobian`` and ``hessian`` take the ``(func, xs)`` form, as the
reference's facade does (it delegates to ``incubate.autograd``'s dense
``Jacobian`` and ``Hessian``, whose part this module ports over
``torch.autograd.functional``); the form over computed outputs raises as
the reference's does.

``PyLayer`` is ``torch.autograd.Function`` with Paddle's names
(``pylayer.py``). ``callbacks.py`` holds the tape's grad-ready and
post-backward callbacks, which the data-parallel reducer keys on. The
reference's ``apply``, ``defop`` and ``GradNode`` build its own op tape
over ``jax.vjp``; torch's autograd is their counterpart, so they have no
port.
"""
from __future__ import annotations

import torch

from .callbacks import (register_grad_ready_callback,
                        register_post_backward_callback,
                        unregister_grad_ready_callback,
                        unregister_post_backward_callback)
from .pylayer import PyLayer, PyLayerContext

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

_UNUSED = ("One of the differentiated Tensors appears unused in the graph; "
           "set allow_unused=True to return None for it.")


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``. ``create_graph=True`` returns
    differentiable gradients. Returns a list, ``None`` for an unused
    input when ``allow_unused``."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    hooks = [t.register_hook(torch.zeros_like)
             for t in ([] if no_grad_vars is None else _as_list(no_grad_vars))
             if t.requires_grad]
    try:
        grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=True)
    finally:
        for h in hooks:
            h.remove()
    if not allow_unused and any(g is None for g in grads):
        raise ValueError(_UNUSED)
    return list(grads)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate the gradients of ``tensors``
    (seeded by ``grad_tensors``, ones where None) into the leaves'
    ``.grad``."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


class Jacobian:
    """The dense Jacobian of ``func`` at one tensor ``x``
    (``incubate.autograd.Jacobian``): ``[out_numel, in_numel]``, or with
    ``is_batched`` the per-sample ``[batch, out, in]`` blocks over axis
    0. Index it like a tensor; ``numpy()`` gives the array."""

    def __init__(self, func, xs, is_batched=False):
        if len(xs) != 1:
            raise ValueError("Jacobian supports a single xs tensor")
        x = xs[0].detach()
        jac = torch.autograd.functional.jacobian(func, x)
        out_n = jac.numel() // max(x.numel(), 1)
        if is_batched:
            b = x.shape[0]
            jacb = jac.reshape(b, -1, b, x[0].numel())
            idx = torch.arange(b)
            self._m = jacb[idx, :, idx, :]
        else:
            self._m = jac.reshape(out_n, x.numel())

    @property
    def shape(self):
        return list(self._m.shape)

    def __getitem__(self, idx):
        return self._m[idx]

    def numpy(self):
        return self._m.numpy(force=True)


class Hessian(Jacobian):
    """The dense Hessian of ``sum(func(x))`` at one tensor ``x``:
    ``[numel, numel]``."""

    def __init__(self, func, xs, is_batched=False):
        if len(xs) != 1:
            raise ValueError("Hessian supports a single xs tensor")
        x = xs[0].detach()
        h = torch.autograd.functional.hessian(lambda a: func(a).sum(), x)
        self._m = h.reshape(x.numel(), x.numel())


def jacobian(ys, xs, batch_axis=None):
    """paddle.autograd.jacobian in its ``(func, xs)`` form."""
    if callable(ys):
        return Jacobian(ys, _as_list(xs), is_batched=batch_axis is not None)
    raise NotImplementedError(
        "paddle.autograd.jacobian over already-computed outputs needs the "
        "functional form: pass the function as the first argument "
        "(jacobian(func, xs))")


def hessian(ys, xs, batch_axis=None):
    """paddle.autograd.hessian in its ``(func, xs)`` form."""
    if callable(ys):
        return Hessian(ys, _as_list(xs), is_batched=batch_axis is not None)
    raise NotImplementedError(
        "paddle.autograd.hessian needs the functional form "
        "(hessian(func, xs))")


__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "grad", "backward", "jacobian", "hessian", "PyLayer",
           "PyLayerContext", "register_grad_ready_callback",
           "unregister_grad_ready_callback",
           "register_post_backward_callback",
           "unregister_post_backward_callback"]
