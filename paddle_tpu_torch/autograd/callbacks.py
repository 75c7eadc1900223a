"""Grad-ready and post-backward callbacks (port of
``paddle_tpu/autograd/tape.py:164-211``), the signals the data-parallel
reducer keys on, over ``Tensor.register_post_accumulate_grad_hook``.

* :func:`register_grad_ready_callback` fires ``cb(t)`` the moment a
  leaf's gradient is final for the current backward: once a leaf per
  backward, in the order leaves become final, again on a second backward
  with ``retain_graph``, never under ``autograd.grad`` (it accumulates
  into no ``.grad``) and never for a leaf the backward does not reach.
* :func:`register_post_backward_callback` fires ``cb()`` once at the end
  of every backward that accumulates into one of its tensors, after the
  last node (``queue_callback`` of torch's engine, as
  ``torch.nn.parallel.DistributedDataParallel`` flushes its buckets).

The reference's tape walks every leaf of every backward, so its
callbacks take no tensors. torch's hooks live on the tensors, so both
functions take the tensors to watch (ROADMAP C53). On a CUDA tensor the
hooks run on the autograd engine's device thread, which the calling
thread waits on: a callback sees the state ``backward()`` returns with.
"""
from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_ready: dict = {}        # callback -> hook handles
_post: dict = {}         # callback -> (hook handles, [queued])


def _leaves(tensors):
    return [t for t in tensors if t is not None and t.requires_grad]


def register_grad_ready_callback(cb, tensors):
    """Call ``cb(t)`` whenever leaf ``t`` of ``tensors`` has its final
    gradient in a backward. Returns ``cb``."""
    handles = [t.register_post_accumulate_grad_hook(cb)
               for t in _leaves(tensors)]
    with _lock:
        _ready.setdefault(cb, []).extend(handles)
    return cb


def unregister_grad_ready_callback(cb):
    with _lock:
        handles = _ready.pop(cb, [])
    for h in handles:
        h.remove()


def register_post_backward_callback(cb, tensors):
    """Call ``cb()`` once at the end of each backward that accumulates a
    gradient into any of ``tensors``. Returns ``cb``."""
    queued = [False]

    def run():
        queued[0] = False
        cb()

    def on_leaf(_t):
        with _lock:
            if queued[0]:
                return
            queued[0] = True
        torch.autograd.Variable._execution_engine.queue_callback(run)

    handles = [t.register_post_accumulate_grad_hook(on_leaf)
               for t in _leaves(tensors)]
    with _lock:
        _post.setdefault(cb, []).extend(handles)
    return cb


def unregister_post_backward_callback(cb):
    with _lock:
        handles = _post.pop(cb, [])
    for h in handles:
        h.remove()
