"""Quantization (port of ``paddle_tpu/quantization/__init__.py``).

* Fake quantisation for quantisation-aware training: :func:`fake_quant`
  (a quantise-dequantise pair with the reference's straight-through
  gradient), the observers and quanters (:class:`AbsmaxObserver`,
  :class:`FakeQuanterWithAbsMaxObserver`) and :class:`QuantConfig`.
* The wrappers :class:`QuantedLinear` and :class:`QuantedConv2D`, swapped
  in for ``Linear`` and ``Conv2D`` (exact type) by :meth:`QAT.quantize`
  (fake quant in the forward) or :meth:`PTQ.quantize` (observers only);
  :func:`calibrate` runs sample data through them, and :func:`convert`
  freezes per-output-channel int8 weights: a converted
  ``QuantedLinear``'s eval forward is the op ``"int8_linear"`` through
  kernel B10 (:func:`~paddle_tpu_torch.ops.quant_matmul.int8_matmul`), a
  converted ``QuantedConv2D``'s a convolution on the dequantised filter.
* Weight-only int8 inference for a whole model: :func:`quantize_linears`
  gives every ``torch.nn.Linear`` the reference Linear's quantised
  behaviour (``nn/layers/common.py:17-42``): its eval forward streams
  int8 codes through B10, its train forward uses ``.weight``, which now
  holds the dequantised values. The codes ``[out, in]`` and scales
  ``[out]`` are non-persistent buffers, so ``state_dict`` keys do not
  change and ``.to()`` moves them with the layer.

Observers keep the reference's Python-float scales: each observation
reads ``max |x|`` back to the host (one device sync per observed tensor,
as ``float(jnp.max(...))`` does in the reference).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .. import amp
from ..nn import functional as F
from ..nn.layer import Layer
from ..nn.layers.common import Linear, _linear
from ..nn.layers.conv import Conv2D
from ..ops.quant_matmul import int8_matmul, quantize_weight

__all__ = ["QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMaxObserver",
           "AbsmaxObserver", "quanted_layers", "QuantedLinear",
           "QuantedConv2D", "calibrate", "convert", "fake_quant",
           "quantize_linears", "int8_linear"]


# -- fake quantisation (straight-through estimator) ---------------------------

def _div(a, b):
    """``a / b`` for a Python number ``b`` as a true division: CUDA would
    multiply by the reciprocal of a Python scalar."""
    return a / torch.full_like(a, b)


class _FakeQuant(torch.autograd.Function):
    """``clip(round(x / s * qmax), -qmax, qmax) * s / qmax`` with ``s =
    max(scale, 1e-8)`` (reference ``:31-35``); the gradient passes to x
    where ``|x| <= s`` and is zero elsewhere, and none reaches the scale
    (``:42-46``)."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        s = scale.clamp_min(1e-8)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        ctx.save_for_backward(x, s)
        return _div(q * s, qmax)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return torch.where(x.abs() <= s, g, 0.0), torch.zeros_like(s), None


def fake_quant(x, scale, bit_length=8):
    """Quantise-dequantise ``x`` with the symmetric scale ``scale`` (a
    0-dim tensor or a Python number) to ``bit_length`` bits, with the
    straight-through gradient. The reference's op ``"fake_quant"``: AMP
    casts x and the scale."""
    qmax = float(2 ** (bit_length - 1) - 1)
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32,
                             device=x.device)
    x, scale = amp.amp_cast_inputs("fake_quant", [x, scale])
    return _FakeQuant.apply(x, scale, qmax)


# -- observers and quanters ---------------------------------------------------

class AbsmaxObserver:
    """Post-training observer: a running abs-max, the scale (a Python
    float) moving by ``moving_rate`` after the first observation."""

    def __init__(self, quant_bits=8, moving_rate=0.9):
        self.quant_bits = quant_bits
        self.moving_rate = moving_rate
        self.scale = 0.0

    def observe(self, x):
        m = float(x.detach().abs().max())
        if self.scale == 0.0:
            self.scale = m
        else:
            self.scale = (self.moving_rate * self.scale
                          + (1 - self.moving_rate) * m)
        return x

    def _instance(self, layer=None):
        return copy.copy(self)


class FakeQuanterWithAbsMaxObserver(AbsmaxObserver):
    """Quantisation-aware training's quanter: observe the abs-max, then
    fake-quantise with the scale (reference
    ``FakeQuanterWithAbsMaxObserverLayer``)."""

    def quantize(self, x):
        self.observe(x)
        return fake_quant(x, torch.tensor(self.scale, dtype=torch.float32,
                                          device=x.device),
                          self.quant_bits)


class QuantConfig:
    """The quanters for activations and weights, for the whole model or
    per layer (:meth:`add_layer_config`)."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight
        self._layer_configs = {}

    def add_layer_config(self, layer=None, activation=None, weight=None,
                         **kw):
        for one in (layer if isinstance(layer, (list, tuple)) else [layer]):
            self._layer_configs[id(one)] = (activation, weight)

    def _for(self, layer):
        return self._layer_configs.get(id(layer),
                                       (self.activation, self.weight))


def _apply_quanter(q, t):
    """Quanters fake-quantise; plain observers only observe."""
    if hasattr(q, "quantize"):
        return q.quantize(t)
    q.observe(t)
    return t


# -- the quantised layer wrappers ---------------------------------------------

class _Quanted(Layer):
    """What both wrappers share: the wrapped layer as ``inner`` (so the
    parameters are ``<name>.inner.weight``, as in the reference), one
    quanter instance per wrapper, and after :func:`convert` the codes and
    per-output-channel scales as buffers ``_w_int8`` and ``_w_scale``
    (in ``state_dict``, so :func:`~paddle_tpu_torch.convert.load_jax_state`
    and ``jax_layout`` carry them) and ``act_scale``."""

    def __init__(self, inner, a_quanter, w_quanter):
        super().__init__()
        self.inner = inner
        self.a_q = a_quanter._instance(inner) if a_quanter else None
        self.w_q = w_quanter._instance(inner) if w_quanter else None
        self._converted = False
        self.act_scale = None

    def _freeze(self, q, scale):
        self.register_buffer("_w_int8", q)
        self.register_buffer("_w_scale", scale)
        self._converted = True
        self.act_scale = (float(self.a_q.scale) if self.a_q is not None
                          else None)

    @property
    def int8_weight(self):
        """The frozen codes (the reference's inspection attribute)."""
        return self._w_int8

    @property
    def weight_scale(self):
        """The largest channel's abs-max (``max(scale) * 127``)."""
        return float(self._w_scale.max() * 127.0)


class QuantedLinear(_Quanted):
    """A ``Linear`` under quantisation. Training (or before
    :func:`convert`): the activation and weight quanters, then the
    layer's op ``"linear"``. Converted, in eval: the op ``"int8_linear"``
    on the frozen codes ``[out, in]`` (B10), outside autograd."""

    def forward(self, x):
        if self._converted and not self.training:
            return int8_linear(x, self._w_int8, self._w_scale,
                               self.inner.bias)
        if self.a_q is not None:
            x = _apply_quanter(self.a_q, x)
        w = self.inner.weight
        if self.w_q is not None:
            w = _apply_quanter(self.w_q, w)
        return _linear(x, w, self.inner.bias)


class QuantedConv2D(_Quanted):
    """A ``Conv2D`` under quantisation. Training: the activation quanter,
    then the convolution on the fake-quantised filter (a plain observer
    observes the filter and the layer runs as it is). Converted, in eval:
    the convolution on the filter dequantised from the frozen codes
    ``[out_c, in_c, kh, kw]`` and scales, in the filter's dtype, outside
    autograd."""

    def forward(self, x):
        inner = self.inner
        args = inner._conv_args()[1:]
        if self._converted and not self.training:
            w = (self._w_int8.float()
                 * self._w_scale[:, None, None, None]).to(inner.weight.dtype)
            with torch.no_grad():
                return F.conv2d(x, w, *args)
        if self.a_q is not None:
            x = _apply_quanter(self.a_q, x)
        if self.w_q is None or not hasattr(self.w_q, "quantize"):
            if self.w_q is not None:
                self.w_q.observe(inner.weight)     # calibration
            return inner(x)
        return F.conv2d(x, self.w_q.quantize(inner.weight), *args)


def quanted_layers():
    """The layer types ``QAT`` and ``PTQ`` swap, and their wrappers."""
    return {Linear: QuantedLinear, Conv2D: QuantedConv2D}


def _swap_layers(model, make_wrapper):
    """Replace, in place, every sublayer whose type is exactly a key of
    :func:`quanted_layers` by ``make_wrapper(wrapper_cls, layer)``;
    recurse into the others. Returns ``model``."""
    table = quanted_layers()
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        wrapper_cls = table.get(type(sub))
        if wrapper_cls is not None:
            model._modules[name] = make_wrapper(wrapper_cls, sub)
        else:
            _swap_layers(sub, make_wrapper)
    return model


class QAT:
    """Quantisation-aware training: ``QAT(config).quantize(model)`` swaps
    ``Linear`` and ``Conv2D`` for fake-quant wrappers, in place; training
    goes on; :meth:`convert` freezes the int8 weights."""

    def __init__(self, q_config: QuantConfig):
        self.config = q_config

    def quantize(self, model, inplace=True):
        def make(cls, sub):
            a, w = self.config._for(sub)
            return cls(sub, a, w)

        return _swap_layers(model, make)

    def convert(self, model, inplace=True):
        return convert(model)


class PTQ(QAT):
    """Post-training quantisation: observers only (no fake quant in the
    forward), :func:`calibrate` on sample data, then :func:`convert`."""


def convert(model):
    """Freeze calibrated quantisation, in place: every
    :class:`QuantedLinear` gets its weight's per-output-channel int8 codes
    and scales (:func:`quantize_weight`, in the weight's own dtype, C12)
    and its ``.weight`` becomes the fp32 product ``q * scale``, as the
    reference's (``:268``); every :class:`QuantedConv2D` gets per
    output-channel codes of its filter (abs-max over the other axes,
    divided by 127 in the filter's dtype) and its filter becomes ``q *
    scale`` in its own dtype. Each records ``act_scale`` from its
    activation observer (activations stay float: weight-only int8).
    Returns ``model``."""
    for sub in model.modules():
        if isinstance(sub, QuantedLinear):
            w = sub.inner.weight
            with torch.no_grad():
                q, scale = quantize_weight(w)
                w.data = q.float() * scale[:, None]
            sub._freeze(q, scale)
        elif isinstance(sub, QuantedConv2D):
            w = sub.inner.weight                  # [out_c, in_c, kh, kw]
            with torch.no_grad():
                amax = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8)
                scale = _div(amax, 127.0)
                q = torch.round(w / scale[:, None, None, None]).clamp(
                    -127, 127).to(torch.int8)
                scale = scale.float()
                w.data = (q.float() * scale[:, None, None, None]).to(w.dtype)
            sub._freeze(q, scale)
    return model


@torch.no_grad()
def calibrate(model, data, steps=None):
    """Post-training calibration: run ``data`` (a ``DataLoader`` or any
    iterable of batches or ``(batch, label)`` pairs) through the
    observer-wrapped ``model`` in eval mode, so that every observer sees
    real ranges; at most ``steps`` batches. Returns the number of batches
    observed."""
    was_training = model.training
    model.eval()
    dev = next(iter(model.parameters())).device
    n = 0
    try:
        for item in data:
            x = item[0] if isinstance(item, (tuple, list)) else item
            model(torch.as_tensor(x, device=dev))
            n += 1
            if steps is not None and n >= steps:
                break
    finally:
        if was_training:
            model.train()
    return n


# -- weight-only int8 inference -----------------------------------------------

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
