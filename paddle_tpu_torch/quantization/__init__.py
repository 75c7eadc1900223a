"""Weight-only int8 inference for ``nn.Linear`` (port of
``int8_linear`` and ``quantize_linears`` in
``paddle_tpu/quantization/__init__.py``).

:func:`quantize_linears` gives every ``torch.nn.Linear`` of a model the
reference Linear's quantised behaviour (``nn/layers/common.py:17-42``):
its eval forward streams int8 codes through kernel B10
(:func:`~paddle_tpu_torch.ops.quant_matmul.int8_matmul`), its train
forward uses ``.weight``, which now holds the dequantised values. The
codes ``[out, in]`` and scales ``[out]`` are non-persistent buffers, so
``state_dict`` keys do not change and ``.to()`` moves them with the
layer.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import amp
from ..nn.layers.common import Linear
from ..ops.quant_matmul import int8_matmul, quantize_weight

__all__ = ["int8_linear", "quantize_linears"]


def int8_linear(x, w_int8, w_scale, bias=None):
    """Weight-only int8 linear: flatten ``x``'s leading dims, run
    :func:`int8_matmul` (codes ``[out, in]``, scales ``[out]``), restore
    the shape, add ``bias``. Inference only: it runs under
    ``torch.no_grad()``, as the reference keeps it off the tape. It is
    the reference's op ``"int8_linear"``: AMP casts its float arguments,
    so under O2 x, the scales and the bias go to the AMP dtype and the
    kernel reads the rounded scales back in fp32, as the reference's
    (``quant_matmul.py:126``)."""
    x, w_int8, w_scale, *bias = amp.amp_cast_inputs(
        "int8_linear", [x, w_int8, w_scale] + ([bias] if bias is not None
                                               else []))
    with torch.no_grad():
        out = int8_matmul(x.reshape(-1, x.shape[-1]), w_int8,
                          w_scale.float())
        out = out.reshape(*x.shape[:-1], out.shape[-1])
        return out + bias[0] if bias else out


class _Int8Linear(Linear):
    """The class :func:`quantize_linears` gives a quantised
    ``nn.Linear``; its train forward is the AMP-aware ``Linear``'s."""

    def forward(self, x):
        if not self.training:
            return int8_linear(x, self.w_int8, self.w_scale, self.bias)
        return super().forward(x)


def quantize_linears(model):
    """Quantise every ``nn.Linear`` of ``model`` that is not quantised
    yet, in place: codes and per-output-channel scales from
    :func:`quantize_weight`, ``.weight`` replaced by ``(q * scale)`` in
    its own dtype (the fp32 product, then the cast), and the eval forward
    routed through B10. Returns the number of layers quantised."""
    count = 0
    for module in model.modules():
        if (not isinstance(module, nn.Linear)
                or isinstance(module, _Int8Linear)):
            continue
        with torch.no_grad():
            q, scale = quantize_weight(module.weight)
            module.weight.copy_((q.float() * scale[:, None]).to(
                module.weight.dtype))
        module.register_buffer("w_int8", q, persistent=False)
        module.register_buffer("w_scale", scale, persistent=False)
        module.__class__ = _Int8Linear
        count += 1
    return count
