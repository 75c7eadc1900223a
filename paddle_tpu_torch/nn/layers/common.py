"""Common layers (port of ``paddle_tpu/nn/layers/common.py``).

``Linear`` and ``Embedding`` are ``Layer``s that are also
``torch.nn.Linear`` / ``torch.nn.Embedding``. ``Linear`` keeps torch's
``[out, in]`` weight (ROADMAP C3): its initializer runs on Paddle's
``[in, out]`` shape, so the fans and an ``Assign`` value are the
reference's, and the result is stored transposed. Its forward is the
reference's op ``"linear"`` with jnp's promotion of mixed float dtypes
(an fp32 input with a bf16 weight computes in fp32)."""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as TF

from ... import amp
from ...framework.param_attr import ParamAttr
from ...ops import manipulation as _manip
from .. import functional as F
from ..initializer import Normal, Uniform, XavierUniform
from ..layer import Layer


def _linear(x, weight, bias=None):
    """``x @ weight.T (+ bias)`` on torch's ``[out, in]`` weight, the
    reference's op ``"linear"``."""
    args = amp.amp_cast_inputs("linear", [x, weight] + (
        [bias] if bias is not None else []))
    return TF.linear(*amp.promote(*args))


class Linear(Layer, nn.Linear):
    """``Linear(in_features, out_features, weight_attr=None,
    bias_attr=None)``: weight ``XavierUniform``, bias 0, unless the attrs
    say otherwise; ``bias_attr=False`` (or torch's ``bias=False``) drops
    the bias. ``device`` and ``dtype`` as for any parameter."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, bias=True, device=None,
                 dtype=None):
        Layer.__init__(self, name, dtype or "float32")
        self.in_features = in_features
        self.out_features = out_features
        attr = ParamAttr._to_attr(weight_attr)
        init = attr.initializer or XavierUniform()
        w = init([in_features, out_features], self._dtype, device)
        self.weight = self._parameter(w.t().contiguous(), attr, init)
        if bias_attr is False or not bias:
            self.register_parameter("bias", None)
        else:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True, device=device)

    def forward(self, x):
        return _linear(x, self.weight, self.bias)


class Embedding(Layer, nn.Embedding):
    """Rows of a ``Normal(0, 1)`` weight; the ``padding_idx`` row starts
    at 0 and its ids give zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        Layer.__init__(self, name, dtype or "float32")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.max_norm, self.norm_type = None, 2.0
        self.scale_grad_by_freq, self.sparse = False, sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0), device=device)
        if padding_idx is not None and self.weight.device.type != "meta":
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        (x,) = amp.amp_cast_inputs("flatten", [x])
        return _manip.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.r, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Bilinear(Layer):
    """``out = x1 W x2 + b``, ``W [out, in1, in2]`` from ``U(-1/sqrt(in1),
    1/sqrt(in1))``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        bound = 1 / math.sqrt(in1_features)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=Uniform(-bound, bound))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Identity", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "PixelShuffle",
           "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D", "Bilinear",
           "CosineSimilarity", "Unfold", "ChannelShuffle"]
