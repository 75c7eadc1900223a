"""The remaining layers (port of ``paddle_tpu/nn/layers/extras.py``):
3-D pooling, ``AdaptiveMaxPool1D`` and unpooling, 1-D and 3-D
transposed convolutions, ``Unflatten``, ``Fold``, ``PixelUnshuffle``,
``PairwiseDistance``, ``SiLU``, ``Softmax2D`` and the last losses, each
over its functional in ``nn/functional``."""
from __future__ import annotations

from ... import amp
from .. import functional as F
from ..layer import Layer
from .conv import _ConvNd


class _Args(Layer):
    """Keeps the arguments it was made with for ``forward``."""

    def __init__(self, *args):
        super().__init__()
        self.args = args


# -------------------------------------------------------------- pooling

class MaxPool3D(_Args):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         return_mask, data_format)

    def forward(self, x):
        return F.max_pool3d(x, *self.args)


class AvgPool3D(_Args):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool3d(x, *self.args)


class AdaptiveAvgPool3D(_Args):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, *self.args)


class AdaptiveMaxPool1D(Layer):
    """The maximum over ``length / output_size`` equal bins (the length
    must divide); ``return_mask`` adds the indices."""

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        out = int(self.output_size)
        length = int(x.shape[-1])
        if length % out:
            raise ValueError(f"AdaptiveMaxPool1D: length {length} not "
                             f"divisible by output_size {out}")
        if self.return_mask:
            return F.max_pool1d_with_index(x, kernel_size=length // out)
        (x,) = amp.amp_cast_inputs("adaptive_max_pool1d", [x])
        n, c, _ = x.shape
        return x.reshape(n, c, out, length // out).amax(dim=-1)


class _MaxUnPool(_Args):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        return type(self)._fn(x, indices, *self.args)


class MaxUnPool1D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool3d)


# -------------------------------------------------------------- convs

class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


# -------------------------------------------------------------- common

class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = int(axis)
        self.shape = list(shape)

    def forward(self, x):
        full = list(x.shape)
        ax = self.axis % len(full)
        (x,) = amp.amp_cast_inputs("reshape", [x])
        return x.reshape(full[:ax] + self.shape + full[ax + 1:])


class Fold(_Args):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__(output_sizes, kernel_sizes, strides, paddings,
                         dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor)


class PairwiseDistance(_Args):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__(p, epsilon, keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, *self.args)


# -------------------------------------------------------------- activations

class SiLU(Layer):
    def forward(self, x):
        return F.silu(x)


class Softmax2D(Layer):
    """Softmax over the channel axis of an NCHW input."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


# -------------------------------------------------------------- losses

class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class PoissonNLLLoss(_Args):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self.args)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.args = (p, margin)
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self.args,
                                   weight=self.weight,
                                   reduction=self.reduction)


class TripletMarginWithDistanceLoss(_Args):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(input, positive,
                                                   negative, *self.args)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid head: owns the internal nodes' weight table
    ``[num_classes - 1, feature_size]`` (``num_classes`` rows with
    ``is_custom``) and bias."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        rows = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter([rows, feature_size],
                                            attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([rows, 1], attr=bias_attr,
                                           is_bias=True))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)


__all__ = ["MaxPool3D", "AvgPool3D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
           "Conv1DTranspose", "Conv3DTranspose", "Unflatten", "Fold",
           "PixelUnshuffle", "PairwiseDistance", "SiLU", "Softmax2D",
           "CTCLoss", "SoftMarginLoss", "PoissonNLLLoss",
           "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "TripletMarginWithDistanceLoss", "HSigmoidLoss"]
