"""Pooling layers (port of ``paddle_tpu/nn/layers/pooling.py``)."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer


class _Pool(Layer):
    """Calls its functional with the arguments it was made with."""
    _fn = None

    def __init__(self, *args):
        super().__init__()
        self.args = args

    def forward(self, x):
        return type(self)._fn(x, *self.args)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         return_mask, data_format)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, exclusive, ceil_mode)


class AdaptiveAvgPool2D(_Pool):
    _fn = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool2D(_Pool):
    _fn = staticmethod(F.adaptive_max_pool2d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool1D(_Pool):
    _fn = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


__all__ = ["MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D"]
