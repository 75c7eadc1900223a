"""Gradient clipping (port of ``paddle_tpu/nn/clip_grad.py``: Paddle's
``ClipGradByGlobalNorm`` and friends, passed to an optimizer as
``grad_clip``).

Each clip maps a list of ``(param, grad)`` pairs to a new list, leaving
pairs whose grad is None or whose param has ``need_clip = False`` as they
are. Norms are taken in fp32; a clipped grad comes back in its own dtype.
``clip_grad_norm_`` and ``clip_grad_value_`` clip the parameters' grads
in place.
"""
from __future__ import annotations

import torch

from ..ops import optimizer_step


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each grad on its own to an L2 norm of at most ``clip_norm``:
    ``g * min(clip_norm / max(norm, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = g.float().square().sum().sqrt()
                scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
                g = (g.float() * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every grad by ``clip_norm / max(global_norm, clip_norm)``,
    where the global norm is the square root of the fp32 sum of squares
    of all clipped grads (reference ``:52-81``). On CUDA the sum is kernel
    K-B (``ops/optimizer_step.py``, :func:`sum_squares_multi_tensor`: per
    chunk, then by tensor in parameter order, deterministic); on the CPU
    its plain version adds the per-tensor sums in parameter order, as the
    reference does. The fused optimizer step takes :meth:`global_scale`
    and folds it into its update; the eager loop calls the clip."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        return optimizer_step.sum_squares_multi_tensor(grads) if grads \
            else None

    def global_scale(self, params_grads):
        """The fp32 scale (a 0-dim tensor on the grads' device), or None
        when no grad is clipped."""
        total = self._global_norm_sq(params_grads)
        if total is None:
            return None
        return self.clip_norm / total.sqrt().clamp_min(self.clip_norm)

    @staticmethod
    def scaled(params_grads, scale):
        """Each clipped grad times ``scale``, in fp32, cast back to its
        dtype (the others as they are)."""
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g)
                 else g) for p, g in params_grads]

    @torch.no_grad()
    def __call__(self, params_grads):
        scale = self.global_scale(params_grads)
        if scale is None:
            return params_grads
        return self.scaled(params_grads, scale)


def _grads_of(parameters):
    params = ([parameters] if isinstance(parameters, torch.Tensor)
              else list(parameters))
    return [p for p in params if p.grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the grads of ``parameters`` (a tensor or an iterable of them)
    in place to a total ``norm_type`` norm of at most ``max_norm``
    (reference ``:84-98``): the total over every grad (the largest
    magnitude for ``inf``, in the grads' dtype; else ``sum |g|^p`` in
    fp32, then the p-th root), the scale ``min(max_norm / max(total,
    1e-6), 1)``, each grad times it cast back to its dtype. Returns the
    total (a 0-dim tensor; zeros on the CPU when no parameter has a
    grad). ``error_if_nonfinite`` raises for a total that is not
    finite."""
    params = _grads_of(parameters)
    if not params:
        return torch.zeros([])
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"the total norm of order {norm_type} of the "
                           f"gradients is not finite")
    scale = (torch.full_like(total, float(max_norm))
             / total.clamp_min(1e-6)).clamp_max(1.0)
    for p in params:
        p.grad = (p.grad.float() * scale.float()).to(p.grad.dtype)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every element of the parameters' grads to ``[-clip_value,
    clip_value]`` in place (reference ``:101-105``)."""
    for p in _grads_of(parameters):
        p.grad.clamp_(-clip_value, clip_value)
