"""``paddle.incubate`` (port of ``paddle_tpu/incubate/``): the top-level
functions (``graph_send_recv``, the fused masked softmaxes,
``identity_loss`` and the segment pools) and
``distributed.models.moe``, the mixture-of-experts layer and its GShard
dispatch. The fused layers, ``asp``, ``autograd`` and ``optimizer`` are
not ported yet."""
import torch

from . import distributed  # noqa: F401
from ..geometric import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_sum,
)
from ..geometric import send_u_recv as _send_u_recv
from ..ops._util import as_tensor as _as_tensor


def graph_send_recv(x, src_index, dst_index, pool_type="sum", out_size=None,
                    name=None):
    """The legacy name of ``geometric.send_u_recv``."""
    return _send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis, computed in fp32 and
    returned in ``x``'s dtype."""
    x = _as_tensor(x)
    z = (x + _as_tensor(mask, x)).float()
    return torch.softmax(z, dim=-1).to(x.dtype)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last axis: the entries above the diagonal
    are masked out; fp32 inside, ``x``'s dtype out."""
    x = _as_tensor(x)
    keep = torch.ones(x.shape[-2], x.shape[-1], dtype=torch.bool,
                      device=x.device).tril()
    z = x.float().masked_fill(~keep, float("-inf"))
    return torch.softmax(z, dim=-1).to(x.dtype)


def identity_loss(x, reduction="none"):
    """``x`` itself, its mean or its sum (``reduction`` ``"none"``,
    ``"mean"``, ``"sum"``)."""
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x
