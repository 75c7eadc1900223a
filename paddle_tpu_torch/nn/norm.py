"""RMSNorm (port of ``paddle_tpu/nn/functional/norm.py:33`` and
``paddle_tpu/nn/layers/norm.py:117``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import amp


def rms_norm(x, weight=None, epsilon=1e-6):
    """The reference's op ``"rms_norm"``: its inputs cast by the AMP
    policy, then normalised over the last axis in float32, cast back to
    ``x``'s dtype and scaled by ``weight`` (jnp's promotion where the two
    dtypes differ)."""
    args = amp.amp_cast_inputs("rms_norm", [x] + (
        [weight] if weight is not None else []))
    x = args[0]
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is None:
        return out
    out, w = amp.promote(out, args[1])
    return out * w


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype=None, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=dtype,
                                              device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
