"""``paddle.vision.ops`` (port of ``paddle_tpu/vision/ops.py``): box
areas and IoU, ``nms``, ``distance2bbox``, ``roi_align``, ``yolo_box``,
``roi_pool``, ``ps_roi_pool``, ``deform_conv2d``, ``matrix_nms``,
``prior_box``, ``distribute_fpn_proposals`` and the ``RoIAlign``,
``RoIPool``, ``PSRoIPool`` and ``DeformConv2D`` layers. Each is plain
PyTorch on its inputs' device, written as the reference's jnp is
(``roi_align`` samples 2 x 2 points a bin at ``sampling_ratio=-1``, the
reference's choice; ROADMAP C41). ``box_coder`` and
``generate_proposals`` raise, as the reference's do.

``nms`` computes the IoU-over-threshold matrix in one pass on the
boxes' device, with the reference's formula, then runs the greedy scan
once on the host over that matrix: one copy, not one sync a box.
``nms`` returns int64 indices (C26); ``matrix_nms`` and
``distribute_fpn_proposals`` return the reference's int32 ones."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.core import current_device
from ..nn.initializer import XavierUniform
from ..nn.layer import Layer

__all__ = ["nms", "box_area", "box_iou", "distance2bbox", "roi_align",
           "yolo_box", "generate_proposals", "box_coder", "roi_pool",
           "ps_roi_pool", "deform_conv2d", "matrix_nms", "prior_box",
           "distribute_fpn_proposals", "RoIAlign", "RoIPool", "PSRoIPool",
           "DeformConv2D"]


def _tensor(x, device=None):
    """``x`` as a tensor on ``device``; a tensor stays where it is when
    ``device`` is None, numpy arrays and lists land on the current
    device, as ``to_tensor`` puts them."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=current_device()
                           if device is None else device)


def box_area(boxes):
    b = _tensor(boxes)
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou_matrix(a, b):
    """``a [N, 4]``, ``b [M, 4]`` xyxy -> ``[N, M]`` IoU, the reference's
    formula (``ops.py:31``)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(
        1e-10)


def box_iou(boxes1, boxes2):
    return _iou_matrix(_tensor(boxes1), _tensor(boxes2))


def suppression_matrix(boxes, iou_threshold, scores=None,
                       category_idxs=None):
    """``(order, over)``: the boxes' order by descending score (a stable
    sort, as ``jnp.argsort`` is) and the bool matrix of the sorted boxes'
    IoU above ``iou_threshold`` (0 across categories when
    ``category_idxs`` is given), on the boxes' device."""
    b = _tensor(boxes)
    n = b.shape[0]
    s = (_tensor(scores, b.device) if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))
    order = torch.argsort(-s, stable=True)
    bs = b[order]
    iou = _iou_matrix(bs, bs)
    if category_idxs is not None:
        c = _tensor(category_idxs, b.device)[order]
        iou = torch.where(c[:, None] == c[None, :], iou, 0.0)
    return order, iou > iou_threshold


def greedy_keep(over):
    """The greedy scan over the host matrix ``over`` (numpy bool ``[n,
    n]``, row ``j`` the boxes that box ``j`` suppresses): box ``i`` is
    kept unless a kept earlier box suppresses it."""
    n = over.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS: the kept indices (int64, on the boxes' device) by
    descending score; category-aware when ``category_idxs`` is given."""
    order, over = suppression_matrix(boxes, iou_threshold, scores,
                                     category_idxs)
    keep = greedy_keep(over.cpu().numpy())
    idx = order.cpu().numpy()[keep]
    if top_k is not None:
        idx = idx[:top_k]
    return torch.as_tensor(idx.astype(np.int64), device=order.device)


def distance2bbox(points, distance, max_shapes=None):
    """Anchor points ``[..., 2]`` and ltrb distances ``[..., 4]`` -> xyxy
    boxes, clipped to ``max_shapes`` (h, w) when given."""
    p, d = _tensor(points), _tensor(distance)
    out = torch.stack([p[..., 0] - d[..., 0], p[..., 1] - d[..., 1],
                       p[..., 0] + d[..., 2], p[..., 1] + d[..., 3]], -1)
    if max_shapes is not None:
        h, w = max_shapes[0], max_shapes[1]
        out = torch.stack([out[..., 0].clamp(0, w), out[..., 1].clamp(0, h),
                           out[..., 2].clamp(0, w), out[..., 3].clamp(0, h)],
                          -1)
    return out


def _image_of_roi(n, rois_num, r, device):
    """The image index of each of the ``r`` rois, ``rois_num[i]`` of
    image ``i``."""
    return torch.repeat_interleave(
        torch.arange(n, device=device), _tensor(rois_num, device).long(),
        output_size=r)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign: ``x [N, C, H, W]``, ``boxes [R, 4]`` xyxy in image
    coordinates, ``boxes_num [N]`` -> ``[R, C, oh, ow]``, each bin the
    mean of ``sampling_ratio``^2 bilinear samples (2 x 2 when it is not
    positive); ``aligned`` shifts the boxes by half a pixel."""
    oh, ow = _pair(output_size)
    feat = _tensor(x)
    rois = _tensor(boxes, feat.device)
    n, c, h, w = feat.shape
    r = rois.shape[0]
    img = _image_of_roi(n, boxes_num, r, feat.device)
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - off
    y1 = rois[:, 1] * spatial_scale - off
    x2 = rois[:, 2] * spatial_scale - off
    y2 = rois[:, 3] * spatial_scale - off
    rw = (x2 - x1).clamp_min(1e-3)
    rh = (y2 - y1).clamp_min(1e-3)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    dev = feat.device
    ys = (y1[:, None] + (torch.arange(oh * sr, device=dev) + 0.5)[None, :]
          * rh[:, None] / (oh * sr))                          # [R, P]
    xs = (x1[:, None] + (torch.arange(ow * sr, device=dev) + 0.5)[None, :]
          * rw[:, None] / (ow * sr))                          # [R, Q]
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1i = (y0 + 1).clamp(0, h - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    wy = (ys.clamp(0, h - 1) - y0)[:, None, :, None]          # [R,1,P,1]
    wx = (xs.clamp(0, w - 1) - x0)[:, None, None, :]          # [R,1,1,Q]
    ii = img[:, None, None]

    def at(yi, xi):
        # [R, P, Q, C] -> [R, C, P, Q]
        return feat[ii, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    vals = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
            + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return vals.reshape(r, c, oh, sr, ow, sr).mean(dim=(3, 5))


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLO head's ``[N, A * (5 + C), H, W]`` into ``(boxes [N,
    A H W, 4], scores [N, A H W, C])``, scores below ``conf_thresh``
    zeroed (the reference's simplified ``yolo_box``)."""
    na = len(anchors) // 2
    p = _tensor(x)
    imgs = _tensor(img_size, p.device)
    n, _, h, w = p.shape
    dev = p.device
    p = p.reshape(n, na, 5 + class_num, h, w)
    gx = (torch.arange(w, device=dev)[None, None, None, :]
          + 0.5 * (scale_x_y - 1) + torch.sigmoid(p[:, :, 0]) * scale_x_y) / w
    gy = (torch.arange(h, device=dev)[None, None, :, None]
          + 0.5 * (scale_x_y - 1) + torch.sigmoid(p[:, :, 1]) * scale_x_y) / h
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    bw = torch.exp(p[:, :, 2]) * aw / (w * downsample_ratio)
    bh = torch.exp(p[:, :, 3]) * ah / (h * downsample_ratio)
    conf = torch.sigmoid(p[:, :, 4])
    scores = conf[:, :, None] * torch.sigmoid(p[:, :, 5:])  # [n, a, C, h, w]
    imh = imgs[:, 0].float()[:, None, None, None]
    imw = imgs[:, 1].float()[:, None, None, None]
    x1 = (gx - bw / 2) * imw
    y1 = (gy - bh / 2) * imh
    x2 = (gx + bw / 2) * imw
    y2 = (gy + bh / 2) * imh
    if clip_bbox:
        x1 = torch.minimum(x1.clamp_min(0), imw - 1)
        y1 = torch.minimum(y1.clamp_min(0), imh - 1)
        x2 = torch.minimum(x2.clamp_min(0), imw - 1)
        y2 = torch.minimum(y2.clamp_min(0), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    mask = scores.amax(-1, keepdim=True) >= conf_thresh
    return boxes, torch.where(mask, scores, 0.0)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    raise NotImplementedError("box_coder: use distance2bbox / yolo_box "
                              "decoders (as the reference does)")


def generate_proposals(*a, **kw):
    raise NotImplementedError("RPN generate_proposals is two-stage-detector "
                              "specific; the reference ships anchor-free "
                              "decode (distance2bbox) + nms")


def _roi_bins(rois, spatial_scale, oh, ow, h, w):
    """roi_pool's quantized bins (rounded corners, floor / ceil edges):
    row and column membership masks ``[R, oh, H]``, ``[R, ow, W]`` and
    the empty-bin flags ``[R, oh, ow]``. The bin sizes divide by a
    tensor: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which moves ``floor`` and ``ceil`` of an exact multiple
    (a 21-row roi in 7 bins)."""
    dev = rois.device
    rsw = torch.round(rois[:, 0] * spatial_scale)
    rsh = torch.round(rois[:, 1] * spatial_scale)
    rew = torch.round(rois[:, 2] * spatial_scale)
    reh = torch.round(rois[:, 3] * spatial_scale)
    bin_h = (reh - rsh + 1.0).clamp_min(1.0) / torch.full_like(reh, oh)
    bin_w = (rew - rsw + 1.0).clamp_min(1.0) / torch.full_like(rew, ow)
    ih = torch.arange(oh, dtype=torch.float32, device=dev)
    iw = torch.arange(ow, dtype=torch.float32, device=dev)
    hs = (torch.floor(ih[None] * bin_h[:, None]) + rsh[:, None]).clamp(0, h)
    he = (torch.ceil((ih[None] + 1) * bin_h[:, None])
          + rsh[:, None]).clamp(0, h)
    ws = (torch.floor(iw[None] * bin_w[:, None]) + rsw[:, None]).clamp(0, w)
    we = (torch.ceil((iw[None] + 1) * bin_w[:, None])
          + rsw[:, None]).clamp(0, w)
    hh = torch.arange(h, dtype=torch.float32, device=dev)
    ww = torch.arange(w, dtype=torch.float32, device=dev)
    mask_h = ((hh[None, None, :] >= hs[:, :, None])
              & (hh[None, None, :] < he[:, :, None]))
    mask_w = ((ww[None, None, :] >= ws[:, :, None])
              & (ww[None, None, :] < we[:, :, None]))
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
    return mask_h, mask_w, empty


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """RoIPool: the max over each quantized bin, ``[R, C, oh, ow]`` (0 in
    an empty bin), as two masked max reductions."""
    oh, ow = _pair(output_size)
    feat = _tensor(x)
    rois = _tensor(boxes, feat.device)
    n, c, h, w = feat.shape
    img = _image_of_roi(n, boxes_num, rois.shape[0], feat.device)
    mask_h, mask_w, empty = _roi_bins(rois, spatial_scale, oh, ow, h, w)
    fi = feat[img]                                           # [R, C, H, W]
    neg = torch.tensor(-3.4e38, dtype=fi.dtype, device=fi.device)
    t = torch.where(mask_w[:, None, None, :, :], fi[:, :, :, None, :],
                    neg).amax(dim=-1)                        # [R, C, H, ow]
    out = torch.where(mask_h[:, None, :, :, None], t[:, :, None, :, :],
                      neg).amax(dim=3)                       # [R, C, oh, ow]
    return torch.where(empty[:, None], 0.0, out).to(feat.dtype)


def ps_roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive RoI average pool: ``C = out_c * oh * ow`` input
    channels, bin (i, j) of output channel ``o`` reads channel ``o * oh *
    ow + i * ow + j``; ``[R, out_c, oh, ow]``."""
    oh, ow = _pair(output_size)
    feat = _tensor(x)
    rois = _tensor(boxes, feat.device)
    n, c, h, w = feat.shape
    if c % (oh * ow):
        raise ValueError(f"ps_roi_pool needs channels divisible by "
                         f"{oh * ow}, got {c}")
    out_c = c // (oh * ow)
    r = rois.shape[0]
    img = _image_of_roi(n, boxes_num, r, feat.device)
    mask_h, mask_w, empty = _roi_bins(rois, spatial_scale, oh, ow, h, w)
    fi = feat[img].reshape(r, out_c, oh, ow, h, w)
    m = (mask_h[:, None, :, None, :, None].to(fi.dtype)
         * mask_w[:, None, None, :, None, :].to(fi.dtype))  # [R,1,oh,ow,H,W]
    out = (fi * m).sum(dim=(-2, -1)) / m.sum(dim=(-2, -1)).clamp_min(1.0)
    return torch.where(empty[:, None], 0.0, out).to(feat.dtype)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (v2 with ``mask``): ``x [N, Cin, H, W]``,
    ``offset [N, 2 dg kh kw, Ho, Wo]`` as (dy, dx) a kernel point, ``mask
    [N, dg kh kw, Ho, Wo]``, ``weight [Cout, Cin / groups, kh, kw]``.
    Every tap is sampled bilinearly for every output site (each corner
    outside the map zero on its own), then contracted with the weights
    in one einsum; differentiable in x, offset, mask and weight."""
    x, offset, weight = _tensor(x), _tensor(offset), _tensor(weight)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    dg = deformable_groups
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw
    dev = x.device
    off = offset.reshape(n, dg, k, 2, ho, wo)
    ky = torch.repeat_interleave(torch.arange(kh, device=dev) * dh, kw)
    kx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    gy = (torch.arange(ho, device=dev) * sh - ph)[None, :, None] \
        + ky[:, None, None]
    gx = (torch.arange(wo, device=dev) * sw - pw)[None, None, :] \
        + kx[:, None, None]
    ys = gy[None, None] + off[:, :, :, 0]                 # [N, dg, k, ho, wo]
    xs = gx[None, None] + off[:, :, :, 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None]
    wx = (xs - x0)[:, :, None]
    flat = x.reshape(n, dg, cin // dg, h * w)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(n, dg, 1, -1).expand(-1, -1, cin // dg,
                                                         -1)
        vals = torch.gather(flat, 3, idx).reshape(n, dg, cin // dg, k, ho,
                                                  wo)
        return vals * valid[:, :, None].to(x.dtype)

    sampled = (gather(y0, x0) * (1 - wy) * (1 - wx)
               + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx)
               + gather(y0 + 1, x0 + 1) * wy * wx)
    if mask is not None:
        sampled = sampled * _tensor(mask).reshape(n, dg, 1, k, ho, wo)
    xg = sampled.reshape(n, groups, cin // groups, k, ho, wo)
    wg = weight.reshape(groups, cout // groups, cin // groups, k)
    out = torch.einsum("ngckhw,gock->ngohw", xg, wg).reshape(n, cout, ho, wo)
    if bias is not None:
        out = out + _tensor(bias)[None, :, None, None]
    return out


def _matrix_nms_decay(bx, s, score_threshold, k, off, use_gaussian,
                      gaussian_sigma):
    """One class of ``matrix_nms`` on the device: the top ``k`` boxes'
    order and their decayed scores (``-inf`` below the threshold)."""
    s = torch.where(s >= score_threshold, s, -torch.inf)
    order = torch.argsort(-s, stable=True)[:k]
    bs, ss = bx[order], s[order]
    lt = torch.maximum(bs[:, None, :2], bs[None, :, :2])
    rb = torch.minimum(bs[:, None, 2:], bs[None, :, 2:])
    wh = (rb - lt + off).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area = (bs[:, 2] - bs[:, 0] + off) * (bs[:, 3] - bs[:, 1] + off)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp_min(1e-10)
    tri = torch.tril(iou, diagonal=-1)
    max_iou = tri.amax(dim=1)
    if use_gaussian:
        decay = torch.exp((max_iou[None, :] ** 2 - tri ** 2) * gaussian_sigma)
    else:
        decay = (1.0 - tri) / (1.0 - max_iou[None, :]).clamp_min(1e-10)
    below = torch.tril(torch.ones_like(tri), diagonal=-1) > 0
    decay = torch.where(below, decay, torch.inf).amin(dim=1)
    decay = torch.where(torch.isinf(decay), 1.0, decay)
    return order, torch.where(torch.isfinite(ss), ss * decay, -torch.inf)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, normalized=True):
    """Matrix NMS (SOLOv2's decay): ``bboxes [N, 4]``, ``scores [C, N]``
    -> ``(out [M, 6]`` = (label, score, x1, y1, x2, y2), ``index [M]``
    int32). The decays are computed per class on the device, then one
    copy to the host, where the rows are filtered and sorted by numpy's
    default sort, as the reference's are."""
    bx = _tensor(bboxes)
    sc = _tensor(scores, bx.device)
    n_cls, n = sc.shape
    k = min(int(nms_top_k), n)
    off = 0.0 if normalized else 1.0
    per = [_matrix_nms_decay(bx, sc[c], score_threshold, k, off,
                             use_gaussian, gaussian_sigma)
           for c in range(n_cls)]
    orders = torch.stack([o for o, _ in per]).cpu().numpy()
    dscores = torch.stack([d for _, d in per]).cpu().numpy()
    bx_np = bx.detach().cpu().numpy()
    rows = []
    for c in range(n_cls):
        keep = dscores[c] >= max(float(post_threshold), 1e-38)
        on, dn = orders[c][keep], dscores[c][keep]
        if len(on):
            rows.append(np.column_stack([
                np.full(len(on), c, np.float32), dn.astype(np.float32),
                bx_np[on].astype(np.float32), on.astype(np.float32)]))
    if not rows:
        return (torch.zeros((0, 6), dtype=torch.float32, device=bx.device),
                torch.zeros((0,), dtype=torch.int32, device=bx.device))
    cat = np.concatenate(rows)
    cat = cat[np.argsort(-cat[:, 1])][: int(keep_top_k)]
    return (torch.as_tensor(cat[:, :6], device=bx.device),
            torch.as_tensor(cat[:, 6].astype(np.int32), device=bx.device))


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes: ``(boxes [H, W, P, 4], variances [H, W, P, 4])``
    for every cell of ``input``'s map, normalized by ``image``'s size, on
    ``input``'s device."""
    h, w = input.shape[-2], input.shape[-1]
    imh, imw = int(image.shape[-2]), int(image.shape[-1])
    step_h = steps[1] or imh / h
    step_w = steps[0] or imw / w
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []
    for mi, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                mx = max_sizes[mi]
                whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[mi]
                whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    cx = (np.arange(w) + offset) * step_w
    cy = (np.arange(h) + offset) * step_h
    boxes = np.zeros((h, w, len(whs), 4), np.float32)
    for pi, (bw, bh) in enumerate(whs):
        boxes[:, :, pi, 0] = (cx[None, :] - bw / 2) / imw
        boxes[:, :, pi, 1] = (cy[:, None] - bh / 2) / imh
        boxes[:, :, pi, 2] = (cx[None, :] + bw / 2) / imw
        boxes[:, :, pi, 3] = (cy[:, None] + bh / 2) / imh
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(np.asarray(variance, np.float32), boxes.shape)
    dev = (input.device if isinstance(input, torch.Tensor)
           else current_device())
    return (torch.as_tensor(boxes, device=dev),
            torch.as_tensor(np.array(vars_), device=dev))


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None):
    """Assign RoIs to FPN levels, ``floor(refer_level + log2(sqrt(area) /
    refer_scale))`` clipped to the levels: ``(rois per level, restore
    index [N, 1] int32, per-image counts per level (int32) or None)``, on
    the rois' device; the assignment runs on the host, as the
    reference's does."""
    r = _tensor(fpn_rois)
    dev = r.device
    rois = r.detach().cpu().numpy()
    off = 1.0 if pixel_offset else 0.0
    ws = rois[:, 2] - rois[:, 0] + off
    hs = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(ws * hs, 1e-12))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-8))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    nums_in = None
    if rois_num is not None:
        nums_in = _tensor(rois_num).cpu().numpy().reshape(-1)
        img_idx = np.repeat(np.arange(len(nums_in)), nums_in)
    multi_rois, out_nums, order = [], [], []
    for lv in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == lv)[0]
        multi_rois.append(torch.as_tensor(rois[idx], device=dev))
        order.extend(idx.tolist())
        if nums_in is not None:
            per_img = np.bincount(img_idx[idx], minlength=len(nums_in))
            out_nums.append(torch.as_tensor(per_img.astype(np.int32),
                                            device=dev))
    restore = np.empty((len(order), 1), np.int32)
    restore[np.asarray(order, np.int64), 0] = np.arange(len(order))
    return (multi_rois, torch.as_tensor(restore, device=dev),
            out_nums if nums_in is not None else None)


class RoIAlign:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return ps_roi_pool(x, boxes, boxes_num, self.output_size,
                           self.spatial_scale)


class DeformConv2D(Layer):
    """Owns the weight (``XavierUniform`` unless ``weight_attr`` says
    otherwise) and bias; the offset (and the v2 mask) come in at
    ``forward``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups, groups=groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *ks],
            attr=weight_attr or XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             **self._attrs)
