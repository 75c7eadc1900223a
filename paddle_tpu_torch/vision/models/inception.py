"""GoogLeNet and InceptionV3 (port of ``paddle_tpu/vision/models/
inception.py``). GoogLeNet in training mode returns ``(logits, out1,
out2)``: its auxiliary heads after inception 4a and 4d, in the
reference's order. The layers land on the current device, as ResNet's
do."""
from __future__ import annotations

from ... import nn
from ...amp import sites
from .resnet import _flatten


class _BNConv(nn.Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                      bias_attr=False),
            nn.BatchNorm2D(out_c), nn.ReLU())


class _Inception(nn.Layer):
    """GoogLeNet's block: 1 x 1, 3 x 3, 5 x 5 and pool branches."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, pool_proj):
        super().__init__()
        self.b1 = _BNConv(in_c, c1, 1)
        self.b2 = nn.Sequential(_BNConv(in_c, c3r, 1),
                                _BNConv(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_BNConv(in_c, c5r, 1),
                                _BNConv(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _BNConv(in_c, pool_proj, 1))

    def forward(self, x):
        return sites.concat([self.b1(x), self.b2(x), self.b3(x),
                             self.b4(x)], axis=1)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BNConv(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            _BNConv(64, 64, 1), _BNConv(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, ceil_mode=True))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = nn.Sequential(
                nn.AdaptiveAvgPool2D(4), _BNConv(512, 128, 1), nn.Flatten(),
                nn.Linear(128 * 16, 1024), nn.ReLU(), nn.Dropout(0.7),
                nn.Linear(1024, num_classes))
            self.aux2 = nn.Sequential(
                nn.AdaptiveAvgPool2D(4), _BNConv(528, 128, 1), nn.Flatten(),
                nn.Linear(128 * 16, 1024), nn.ReLU(), nn.Dropout(0.7),
                nn.Linear(1024, num_classes))

    def forward(self, x):
        aux = self.training and self.num_classes > 0
        x = self.i4a(self.pool3(self.i3b(self.i3a(self.stem(x)))))
        a1 = self.aux1(x) if aux else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if aux else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(_flatten(x, 1)))
        return (x, a1, a2) if aux else x


def googlenet(pretrained=False, **kwargs):
    model = GoogLeNet(**kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, "googlenet")
    return model


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_feat):
        super().__init__()
        self.b1 = _BNConv(in_c, 64, 1)
        self.b5 = nn.Sequential(_BNConv(in_c, 48, 1),
                                _BNConv(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_BNConv(in_c, 64, 1),
                                _BNConv(64, 96, 3, padding=1),
                                _BNConv(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _BNConv(in_c, pool_feat, 1))

    def forward(self, x):
        return sites.concat([self.b1(x), self.b5(x), self.b3(x),
                             self.bp(x)], 1)


class _InceptionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _BNConv(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(_BNConv(in_c, 64, 1),
                                 _BNConv(64, 96, 3, padding=1),
                                 _BNConv(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return sites.concat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _BNConv(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _BNConv(in_c, c7, 1), _BNConv(c7, c7, (1, 7), padding=(0, 3)),
            _BNConv(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _BNConv(in_c, c7, 1), _BNConv(c7, c7, (7, 1), padding=(3, 0)),
            _BNConv(c7, c7, (1, 7), padding=(0, 3)),
            _BNConv(c7, c7, (7, 1), padding=(3, 0)),
            _BNConv(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _BNConv(in_c, 192, 1))

    def forward(self, x):
        return sites.concat([self.b1(x), self.b7(x), self.b7d(x),
                             self.bp(x)], 1)


class _InceptionD(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_BNConv(in_c, 192, 1),
                                _BNConv(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _BNConv(in_c, 192, 1),
            _BNConv(192, 192, (1, 7), padding=(0, 3)),
            _BNConv(192, 192, (7, 1), padding=(3, 0)),
            _BNConv(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return sites.concat([self.b3(x), self.b7(x), self.pool(x)], 1)


class _InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _BNConv(in_c, 320, 1)
        self.b3_stem = _BNConv(in_c, 384, 1)
        self.b3_a = _BNConv(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _BNConv(384, 384, (3, 1), padding=(1, 0))
        self.bd_stem = nn.Sequential(_BNConv(in_c, 448, 1),
                                     _BNConv(448, 384, 3, padding=1))
        self.bd_a = _BNConv(384, 384, (1, 3), padding=(0, 1))
        self.bd_b = _BNConv(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _BNConv(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.bd_stem(x)
        return sites.concat([self.b1(x),
                             sites.concat([self.b3_a(s), self.b3_b(s)], 1),
                             sites.concat([self.bd_a(d), self.bd_b(d)], 1),
                             self.bp(x)], 1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BNConv(3, 32, 3, stride=2), _BNConv(32, 32, 3),
            _BNConv(32, 64, 3, padding=1), nn.MaxPool2D(3, stride=2),
            _BNConv(64, 80, 1), _BNConv(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(_flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    model = InceptionV3(**kwargs)
    if pretrained:
        from ._utils import load_pretrained
        load_pretrained(model, "inception_v3")
    return model
