"""Activation layers (port of ``paddle_tpu/nn/layers/activation.py``):
each calls its functional with the keyword options it was made with."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from ..layer import Layer


def _act_layer(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **{k: v for k, v in kwargs.items()
                                           if k != "name"}}

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", lambda x: F.relu(x))
ReLU6 = _act_layer("ReLU6", lambda x: F.relu6(x))
GELU = _act_layer("GELU", lambda x, approximate=False: F.gelu(x, approximate),
                  approximate=False)
Sigmoid = _act_layer("Sigmoid", lambda x: F.sigmoid(x))
Tanh = _act_layer("Tanh", lambda x: F.tanh(x))
Silu = _act_layer("Silu", lambda x: F.silu(x))
Swish = _act_layer("Swish", lambda x: F.silu(x))
Hardswish = _act_layer("Hardswish", lambda x: F.hardswish(x))
Hardsigmoid = _act_layer("Hardsigmoid", lambda x: F.hardsigmoid(x))
Hardtanh = _act_layer("Hardtanh",
                      lambda x, min=-1.0, max=1.0: F.hardtanh(x, min, max),
                      min=-1.0, max=1.0)
LeakyReLU = _act_layer(
    "LeakyReLU", lambda x, negative_slope=0.01: F.leaky_relu(x,
                                                             negative_slope),
    negative_slope=0.01)
ELU = _act_layer("ELU", lambda x, alpha=1.0: F.elu(x, alpha), alpha=1.0)
CELU = _act_layer("CELU", lambda x, alpha=1.0: F.celu(x, alpha), alpha=1.0)
SELU = _act_layer("SELU", lambda x: F.selu(x))
Mish = _act_layer("Mish", lambda x: F.mish(x))
Softplus = _act_layer(
    "Softplus",
    lambda x, beta=1.0, threshold=20.0: F.softplus(x, beta, threshold),
    beta=1.0, threshold=20.0)
Softshrink = _act_layer("Softshrink",
                        lambda x, threshold=0.5: F.softshrink(x, threshold),
                        threshold=0.5)
Hardshrink = _act_layer("Hardshrink",
                        lambda x, threshold=0.5: F.hardshrink(x, threshold),
                        threshold=0.5)
Softsign = _act_layer("Softsign", lambda x: F.softsign(x))
Tanhshrink = _act_layer("Tanhshrink", lambda x: F.tanhshrink(x))
LogSigmoid = _act_layer("LogSigmoid", lambda x: F.log_sigmoid(x))
Softmax = _act_layer("Softmax", lambda x, axis=-1: F.softmax(x, axis),
                     axis=-1)
LogSoftmax = _act_layer("LogSoftmax",
                        lambda x, axis=-1: F.log_softmax(x, axis), axis=-1)
Maxout = _act_layer("Maxout",
                    lambda x, groups=1, axis=1: F.maxout(x, groups, axis),
                    groups=1, axis=1)
GLU = _act_layer("GLU", lambda x, axis=-1: F.glu(x, axis), axis=-1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)


__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Swish",
           "Hardswish", "Hardsigmoid", "Hardtanh", "LeakyReLU", "ELU", "CELU",
           "SELU", "Mish", "Softplus", "Softshrink", "Hardshrink",
           "Softsign", "Tanhshrink", "LogSigmoid", "Softmax", "LogSoftmax",
           "Maxout", "GLU", "PReLU", "RReLU"]
