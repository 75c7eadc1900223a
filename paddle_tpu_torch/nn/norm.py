"""RMSNorm (port of ``paddle_tpu/nn/functional/norm.py:33`` and
``paddle_tpu/nn/layers/norm.py:117``)."""
from __future__ import annotations

import torch
from torch import nn


def rms_norm(x, weight=None, epsilon=1e-6):
    """Normalise over the last axis in float32, cast back to ``x``'s dtype,
    then scale by ``weight``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype=None, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=dtype,
                                              device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
