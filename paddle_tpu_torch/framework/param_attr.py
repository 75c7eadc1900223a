"""ParamAttr (port of ``paddle_tpu/framework/param_attr.py``): what
``Layer.create_parameter`` reads from a layer's ``weight_attr`` or
``bias_attr``."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the defaults, False stays False (no parameter), a string
        names the parameter, anything else is taken as its initializer."""
        if attr is None:
            return ParamAttr()
        if attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)
