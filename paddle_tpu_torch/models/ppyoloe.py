"""PP-YOLOE-style anchor-free detector (port of
``paddle_tpu/models/ppyoloe.py``; PaddleDetection's ``ppyoloe``): a CSP
backbone, a top-down FPN neck, an ET head regressing ltrb distances,
``decode`` (distance to box, sigmoid scores) and ``predict`` with NMS
(``vision/ops.py``), and ``DetectionLoss`` against dense per-point
targets, as the reference's (its task-aligned assigner is
PaddleDetection's model side, not ported there either).

The layers land on the current device (``paddle.get_device()``; call
``paddle.set_device("cpu")`` first where there is no CUDA), as ResNet's
do. ``predict`` keeps the scores and boxes on that device and NMS builds
its IoU matrix there; it returns numpy dicts, as the reference's does.
The sigmoid is written ``1 / (1 + exp(-x))`` in ``decode`` and the
loss, as the reference writes it."""
from __future__ import annotations

import numpy as np
import torch

from ..amp import sites
from ..nn import functional as F
from ..nn.layer import Layer, LayerList, Sequential
from ..nn.layers.conv import Conv2D
from ..nn.layers.norm import BatchNorm2D
from ..vision import ops as vops


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


class ConvBNLayer(Layer):
    def __init__(self, ch_in, ch_out, kernel=3, stride=1, padding=None):
        super().__init__()
        self.conv = Conv2D(ch_in, ch_out, kernel, stride=stride,
                           padding=padding if padding is not None
                           else kernel // 2, bias_attr=False)
        self.bn = BatchNorm2D(ch_out)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class CSPBlock(Layer):
    """Cross-stage-partial block: a conv path and a 1 x 1 path,
    concatenated and fused."""

    def __init__(self, ch, n=1):
        super().__init__()
        mid = ch // 2
        self.conv1 = ConvBNLayer(ch, mid, 1)
        self.conv2 = ConvBNLayer(ch, mid, 1)
        self.blocks = Sequential(*[ConvBNLayer(mid, mid, 3)
                                   for _ in range(n)])
        self.conv3 = ConvBNLayer(mid * 2, ch, 1)

    def forward(self, x):
        a = self.blocks(self.conv1(x))
        return self.conv3(sites.concat([a, self.conv2(x)], axis=1))


class CSPBackbone(Layer):
    """Features at strides 8, 16 and 32."""

    def __init__(self, width=32, depth=1):
        super().__init__()
        w = width
        self.stem = ConvBNLayer(3, w, 3, stride=2)
        self.stage1 = Sequential(ConvBNLayer(w, w * 2, 3, stride=2),
                                 CSPBlock(w * 2, depth))
        self.stage2 = Sequential(ConvBNLayer(w * 2, w * 4, 3, stride=2),
                                 CSPBlock(w * 4, depth))
        self.stage3 = Sequential(ConvBNLayer(w * 4, w * 8, 3, stride=2),
                                 CSPBlock(w * 8, depth))
        self.stage4 = Sequential(ConvBNLayer(w * 8, w * 16, 3, stride=2),
                                 CSPBlock(w * 16, depth))
        self.out_channels = [w * 4, w * 8, w * 16]

    def forward(self, x):
        c3 = self.stage2(self.stage1(self.stem(x)))
        c4 = self.stage3(c3)
        return [c3, c4, self.stage4(c4)]


class FPNNeck(Layer):
    """Top-down fusion: 1 x 1 laterals, nearest 2x upsampling, 3 x 3
    fuse convs."""

    def __init__(self, in_channels, out_ch=96):
        super().__init__()
        self.lateral = LayerList([ConvBNLayer(c, out_ch, 1)
                                  for c in in_channels])
        self.fuse = LayerList([ConvBNLayer(out_ch, out_ch, 3)
                               for _ in in_channels])
        self.out_channels = [out_ch] * len(in_channels)

    def forward(self, feats):
        lat = [m(f) for m, f in zip(self.lateral, feats)]
        outs = [lat[-1]]
        for i in range(len(lat) - 2, -1, -1):
            up = F.interpolate(outs[0], scale_factor=2, mode="nearest")
            outs.insert(0, sites.add(lat[i], up))
        return [f(o) for f, o in zip(self.fuse, outs)]


class ETHead(Layer):
    """Per level: class logits ``[N, C, H, W]`` and ltrb distances ``[N,
    4, H, W]`` (through a ReLU: distances are >= 0)."""

    def __init__(self, in_channels, num_classes=80):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = LayerList([ConvBNLayer(c, c, 3)
                                    for c in in_channels])
        self.reg_convs = LayerList([ConvBNLayer(c, c, 3)
                                    for c in in_channels])
        self.cls_pred = LayerList([Conv2D(c, num_classes, 1)
                                   for c in in_channels])
        self.reg_pred = LayerList([Conv2D(c, 4, 1) for c in in_channels])

    def forward(self, feats):
        cls_outs, reg_outs = [], []
        for f, cc, rc, cp, rp in zip(feats, self.cls_convs, self.reg_convs,
                                     self.cls_pred, self.reg_pred):
            cls_outs.append(cp(cc(f)))
            reg_outs.append(F.relu(rp(rc(f))))
        return cls_outs, reg_outs


class PPYOLOE(Layer):
    """The detector: ``forward`` returns the per-level ``(cls, reg)``
    outputs, ``decode`` flattens them into scores and boxes, ``predict``
    decodes and runs NMS."""

    STRIDES = (8, 16, 32)

    def __init__(self, num_classes=80, width=32, depth=1, neck_ch=96):
        super().__init__()
        self.backbone = CSPBackbone(width, depth)
        self.neck = FPNNeck(self.backbone.out_channels, neck_ch)
        self.head = ETHead(self.neck.out_channels, num_classes)
        self.num_classes = num_classes

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))

    def decode(self, cls_outs, reg_outs):
        """All levels flattened: ``(scores [N, P, C]`` fp32, ``boxes [N, P,
        4]`` in pixels)."""
        all_scores, all_boxes = [], []
        for cl, rg, stride in zip(cls_outs, reg_outs, self.STRIDES):
            n, c, h, w = cl.shape
            dev = cl.device
            px, py = torch.meshgrid((torch.arange(w, device=dev) + 0.5)
                                    * stride,
                                    (torch.arange(h, device=dev) + 0.5)
                                    * stride, indexing="xy")
            pts = torch.stack([px.reshape(-1), py.reshape(-1)], -1)
            scores = cl.permute(0, 2, 3, 1).reshape(n, -1, c)
            dists = rg.permute(0, 2, 3, 1).reshape(n, -1, 4) * stride
            all_scores.append(_sigmoid(scores).float())
            all_boxes.append(torch.stack(
                [pts[None, :, 0] - dists[..., 0],
                 pts[None, :, 1] - dists[..., 1],
                 pts[None, :, 0] + dists[..., 2],
                 pts[None, :, 1] + dists[..., 3]], -1))
        return torch.cat(all_scores, 1), torch.cat(all_boxes, 1)

    def predict(self, x, score_thresh=0.4, iou_thresh=0.5, top_k=100):
        """Per image, a dict of numpy ``boxes``, ``scores`` and ``labels``
        (int64) after category-aware NMS of the points whose best class
        score clears ``score_thresh``."""
        self.eval()
        with torch.no_grad():
            scores, boxes = self.decode(*self.forward(x))
        out = []
        for s, b in zip(scores, boxes):
            conf, lab = s.amax(-1), s.argmax(-1)
            m = conf >= score_thresh
            if not bool(m.any()):
                out.append({"boxes": np.zeros((0, 4), np.float32),
                            "scores": np.zeros((0,), np.float32),
                            "labels": np.zeros((0,), np.int64)})
                continue
            bi, ci, li = b[m], conf[m], lab[m]
            keep = vops.nms(bi, iou_threshold=iou_thresh, scores=ci,
                            category_idxs=li, top_k=top_k)
            out.append({"boxes": bi[keep].cpu().numpy(),
                        "scores": ci[keep].cpu().numpy(),
                        "labels": li[keep].cpu().numpy().astype(np.int64)})
        return out


class DetectionLoss(Layer):
    """Dense per-point loss summed over the levels: the mean BCE of the
    class logits and the masked mean L1 of the distances."""

    def forward(self, cls_outs, reg_outs, cls_targets, reg_targets,
                pos_masks):
        total = 0.0
        for cl, rg, tc, tr, m in zip(cls_outs, reg_outs, cls_targets,
                                     reg_targets, pos_masks):
            p = _sigmoid(cl.float()).clamp(1e-7, 1 - 1e-7)
            bce = -(tc * torch.log(p) + (1 - tc) * torch.log(1 - p)).mean()
            l1 = (torch.abs(rg - tr) * m).sum() / m.sum().clamp_min(1)
            total = total + bce + l1
        return total


def ppyoloe_lite(num_classes=80, **kw):
    return PPYOLOE(num_classes=num_classes, width=16, depth=1, neck_ch=48)
