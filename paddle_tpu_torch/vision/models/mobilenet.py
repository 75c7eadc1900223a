"""MobileNet V1 and V2 (port of ``paddle_tpu/vision/models/
mobilenet.py``). The layers land on the current device, as ResNet's
do."""
from __future__ import annotations

from ... import nn
from ...amp import sites
from .resnet import _flatten


class _ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 relu6=False):
        pad = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_c),
            nn.ReLU6() if relu6 else nn.ReLU())


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
            [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNReLU(3, c(32), stride=2)]
        for in_c, out_c, s in cfg:
            layers.append(_ConvBNReLU(c(in_c), c(in_c), stride=s,
                                      groups=c(in_c)))
            layers.append(_ConvBNReLU(c(in_c), c(out_c), kernel=1))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(_flatten(x, 1))
        return x


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(inp, hidden, kernel=1, relu6=True))
        layers += [
            _ConvBNReLU(hidden, hidden, stride=stride, groups=hidden,
                        relu6=True),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return sites.add(x, out) if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = max(int(32 * scale), 8)
        last_c = max(int(1280 * scale), 8)
        layers = [_ConvBNReLU(3, in_c, stride=2, relu6=True)]
        for t, ch, n, s in cfg:
            out_c = max(int(ch * scale), 8)
            for i in range(n):
                layers.append(_InvertedResidual(in_c, out_c,
                                                s if i == 0 else 1, t))
                in_c = out_c
        layers.append(_ConvBNReLU(in_c, last_c, kernel=1, relu6=True))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV1(scale=scale, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, f"mobilenetv1_{scale}")
    return model


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV2(scale=scale, **kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, f"mobilenetv2_{scale}")
    return model
