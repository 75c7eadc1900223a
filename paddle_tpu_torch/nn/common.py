"""Linear and Embedding (port of ``paddle_tpu/nn/layers/common.py`` and
``nn/functional/common.py:20-36``) as ``torch.nn`` layers whose forward
runs the reference's ops: ``"linear"`` and ``"embedding"`` cast by the
AMP policy, then jnp's promotion of mixed float dtypes (an fp32 input
with a bf16 weight computes in fp32, as ``a @ w`` does in jnp).

``Linear`` keeps ``torch.nn.Linear``'s ``[out, in]`` weight (ROADMAP
C3)."""
from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from .. import amp


def linear(x, weight, bias=None):
    """``x @ weight.T (+ bias)``, the reference's op ``"linear"``."""
    args = amp.amp_cast_inputs("linear", [x, weight] + (
        [bias] if bias is not None else []))
    return F.linear(*amp.promote(*args))


def embedding(ids, weight):
    """Rows of ``weight``, the reference's op ``"embedding"`` (the ids
    are no tensor argument of it)."""
    (weight,) = amp.amp_cast_inputs("embedding", [weight])
    return F.embedding(ids, weight)


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Embedding(nn.Embedding):
    def forward(self, ids):
        return embedding(ids, self.weight)
