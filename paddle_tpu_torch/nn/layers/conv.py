"""Convolution layers (port of ``paddle_tpu/nn/layers/conv.py``). The
weight is Paddle's ``[out_c, in_c / groups, *k]`` (``[in_c, out_c /
groups, *k]`` for a transposed convolution, PyTorch's layouts too);
weight and bias start from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``,
``fan_in = in_c / groups * prod(k)``."""
from __future__ import annotations

import math

import numpy as np

from .. import functional as F
from ..initializer import Uniform
from ..layer import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        ks = (tuple(kernel_size) if isinstance(kernel_size, (list, tuple))
              else (kernel_size,) * nd)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = ks
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self._output_padding = output_padding
        wshape = ([in_channels, out_channels // groups, *ks] if transpose
                  else [out_channels, in_channels // groups, *ks])
        bound = 1.0 / math.sqrt(in_channels // groups * int(np.prod(ks)))
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=Uniform(-bound, bound))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")

    def _conv_args(self):
        return (self.weight, self.bias, self._stride, self._padding,
                self._dilation, self._groups, self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, *self._conv_args())


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, *self._conv_args())


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, *self._conv_args())


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]
