"""AlexNet, SqueezeNet 1.0 / 1.1, MobileNetV3 Small / Large,
ShuffleNetV2 and DenseNet (port of ``paddle_tpu/vision/models/
extras.py``), each the reference's topology. The layers land on the
current device, as ResNet's do."""
from __future__ import annotations

from ... import nn
from ...amp import sites
from ...nn import functional as F
from ...ops import split
from .resnet import _flatten

__all__ = ["AlexNet", "alexnet", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large", "ShuffleNetV2",
           "shufflenet_v2_x1_0", "DenseNet", "densenet121"]


def _load(model, pretrained, arch):
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, arch)
    return model


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(256 * 36, 4096), nn.ReLU(),
            nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        return self.classifier(_flatten(self.avgpool(self.features(x)), 1))


def alexnet(pretrained=False, **kwargs):
    return _load(AlexNet(**kwargs), pretrained, "alexnet")


class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(in_c, squeeze, 1), nn.ReLU())
        self.e1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.e3 = nn.Sequential(nn.Conv2D(squeeze, e3, 3, padding=1),
                                nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return sites.concat([self.e1(s), self.e3(s)], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000):
        super().__init__()
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        return _flatten(self.classifier(self.features(x)), 1)


def squeezenet1_0(pretrained=False, **kwargs):
    return _load(SqueezeNet("1.0", **kwargs), pretrained, "squeezenet1_0")


def squeezenet1_1(pretrained=False, **kwargs):
    return _load(SqueezeNet("1.1", **kwargs), pretrained, "squeezenet1_1")


class _SE(nn.Layer):
    def __init__(self, c, r=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(c, c // r, 1)
        self.fc2 = nn.Conv2D(c // r, c, 1)

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(self.pool(x))))
        return sites.multiply(x, F.hardsigmoid(s))


class _InvertedResidualV3(nn.Layer):
    def __init__(self, in_c, exp, out_c, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        act_layer = nn.Hardswish if act == "hs" else nn.ReLU
        if exp != in_c:
            layers += [nn.Conv2D(in_c, exp, 1, bias_attr=False),
                       nn.BatchNorm2D(exp), act_layer()]
        layers += [nn.Conv2D(exp, exp, k, stride=stride,
                             padding=(k - 1) // 2, groups=exp,
                             bias_attr=False),
                   nn.BatchNorm2D(exp), act_layer()]
        if se:
            layers.append(_SE(exp))
        layers += [nn.Conv2D(exp, out_c, 1, bias_attr=False),
                   nn.BatchNorm2D(out_c)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return sites.add(x, out) if self.use_res else out


_V3_SMALL = [  # k, exp, out, se, act, stride
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hs", 2),
    (5, 240, 40, True, "hs", 1), (5, 240, 40, True, "hs", 1),
    (5, 120, 48, True, "hs", 1), (5, 144, 48, True, "hs", 1),
    (5, 288, 96, True, "hs", 2), (5, 576, 96, True, "hs", 1),
    (5, 576, 96, True, "hs", 1)]
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hs", 2), (3, 200, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1), (3, 184, 80, False, "hs", 1),
    (3, 480, 112, True, "hs", 1), (3, 672, 112, True, "hs", 1),
    (5, 672, 160, True, "hs", 2), (5, 960, 160, True, "hs", 1),
    (5, 960, 160, True, "hs", 1)]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, num_classes=1000, scale=1.0,
                 with_pool=True, head_width=1280):
        super().__init__()
        self.with_pool = with_pool
        self.num_classes = num_classes

        def c(ch):
            return max(int(ch * scale + 4) // 8 * 8, 8)

        layers = [nn.Conv2D(3, c(16), 3, stride=2, padding=1,
                            bias_attr=False),
                  nn.BatchNorm2D(c(16)), nn.Hardswish()]
        in_c = c(16)
        for k, exp, out, se, act, s in cfg:
            layers.append(_InvertedResidualV3(in_c, c(exp), c(out), k, s,
                                              se, act))
            in_c = c(out)
        layers += [nn.Conv2D(in_c, c(last_exp), 1, bias_attr=False),
                   nn.BatchNorm2D(c(last_exp)), nn.Hardswish()]
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(c(last_exp), head_width), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(head_width, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flatten(x, 1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 576, num_classes, scale, with_pool,
                         head_width=1024)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 960, num_classes, scale, with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return _load(MobileNetV3Small(scale=scale, **kwargs), pretrained,
                 f"mobilenet_v3_small_{scale}")


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return _load(MobileNetV3Large(scale=scale, **kwargs), pretrained,
                 f"mobilenet_v3_large_{scale}")


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=stride, padding=1,
                          groups=in_c, bias_attr=False),
                nn.BatchNorm2D(in_c),
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), nn.ReLU())
            b2_in = in_c
        else:
            self.branch1 = None
            b2_in = in_c // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch_c, 1, bias_attr=False),
            nn.BatchNorm2D(branch_c), nn.ReLU(),
            nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                      groups=branch_c, bias_attr=False),
            nn.BatchNorm2D(branch_c),
            nn.Conv2D(branch_c, branch_c, 1, bias_attr=False),
            nn.BatchNorm2D(branch_c), nn.ReLU())

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = split(x, 2, axis=1)
            out = sites.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = sites.concat([self.branch1(x), self.branch2(x)], axis=1)
        return F.channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    _CH = {0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
           1.5: (176, 352, 704, 1024), 2.0: (244, 488, 976, 2048)}

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 act="relu"):
        super().__init__()
        c1, c2, c3, c_out = self._CH[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, 24, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(24), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = 24
        for out_c, repeat in ((c1, 4), (c2, 8), (c3, 4)):
            units = [_ShuffleUnit(in_c, out_c, 2)]
            units += [_ShuffleUnit(out_c, out_c, 1)
                      for _ in range(repeat - 1)]
            stages.append(nn.Sequential(*units))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_c, c_out, 1, bias_attr=False),
            nn.BatchNorm2D(c_out), nn.ReLU())
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if num_classes > 0:
            self.fc = nn.Linear(c_out, num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(_flatten(x, 1))
        return x


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _load(ShuffleNetV2(scale=1.0, **kwargs), pretrained,
                 "shufflenet_v2_x1_0")


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth, bn_size):
        super().__init__()
        self.block = nn.Sequential(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, bn_size * growth, 1, bias_attr=False),
            nn.BatchNorm2D(bn_size * growth), nn.ReLU(),
            nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                      bias_attr=False))

    def forward(self, x):
        return sites.concat([x, self.block(x)], axis=1)


class DenseNet(nn.Layer):
    def __init__(self, layers=121, growth_rate=32, bn_size=4,
                 num_classes=1000, with_pool=True):
        super().__init__()
        cfgs = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
                169: (6, 12, 32, 32), 201: (6, 12, 48, 32)}
        block_cfg = cfgs[layers]
        init_c = 2 * growth_rate
        feats = [nn.Conv2D(3, init_c, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(init_c), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        c = init_c
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth_rate, bn_size))
                c += growth_rate
            if i != len(block_cfg) - 1:
                feats += [nn.BatchNorm2D(c), nn.ReLU(),
                          nn.Conv2D(c, c // 2, 1, bias_attr=False),
                          nn.AvgPool2D(2, stride=2)]
                c //= 2
        feats += [nn.BatchNorm2D(c), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flatten(x, 1))
        return x


def densenet121(pretrained=False, **kwargs):
    return _load(DenseNet(121, **kwargs), pretrained, "densenet121")
