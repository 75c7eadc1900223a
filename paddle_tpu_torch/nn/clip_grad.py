"""Gradient clipping (port of ``paddle_tpu/nn/clip_grad.py``: Paddle's
``ClipGradByGlobalNorm`` and friends, passed to an optimizer as
``grad_clip``).

Each clip maps a list of ``(param, grad)`` pairs to a new list, leaving
pairs whose grad is None or whose param has ``need_clip = False`` as they
are. Norms are taken in fp32; a clipped grad comes back in its own dtype.
"""
from __future__ import annotations

import torch


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
    of all clipped grads, added in parameter order (reference
    ``:52-81``)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        total = None
        for p, g in params_grads:
            if _clipped(p, g):
                sq = g.float().square().sum()
                total = sq if total is None else total + sq
        return total

    @torch.no_grad()
    def __call__(self, params_grads):
        total = self._global_norm_sq(params_grads)
        if total is None:
            return params_grads
        scale = self.clip_norm / total.sqrt().clamp_min(self.clip_norm)
        # scale stays fp32: a bf16 grad is multiplied in fp32, then cast
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]
