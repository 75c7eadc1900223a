"""The port's ``vision/ops.py`` against the reference's, on the same seeded
inputs: every function, forward and, where the reference differentiates,
the gradients of ``sum(out * cot)`` for seeded cotangents, within 1e-5
of each tensor's largest magnitude. ``nms`` keeps exactly the
reference's indices: at ties (both sorts are stable), category-aware,
at a negative threshold (0 IoU across categories then suppresses too)
and on 2,000 boxes; ``matrix_nms`` returns the reference's rows and
indices (ties included: both finish with numpy's default sort of the
same array)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import ops as tops

from torch_vision_common import err, port_on_cpu, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_on_cpu")


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(size * 0.03, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_area_iou_and_distance2bbox():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    run_both(lambda a: jops.box_area(a), lambda a: tops.box_area(a), {"a": a},
             ("a",))
    run_both(lambda a, b: jops.box_iou(a, b), lambda a, b: tops.box_iou(a, b),
             {"a": a, "b": b}, ("a", "b"))
    pts = rng.uniform(0, 64, (2, 9, 2)).astype(np.float32)
    dist = rng.uniform(0, 20, (2, 9, 4)).astype(np.float32)
    for shapes in (None, (48, 40)):
        run_both(lambda p, d: jops.distance2bbox(p, d, shapes),
                 lambda p, d: tops.distance2bbox(p, d, shapes),
                 {"p": pts, "d": dist}, ("p", "d"))


def _nms_pair(boxes, thr, scores=None, cats=None, top_k=None):
    want = jops.nms(boxes, thr, scores=scores, category_idxs=cats,
                    top_k=top_k).numpy()
    got = tops.nms(torch.from_numpy(boxes), thr,
                   scores=None if scores is None else torch.from_numpy(
                       scores),
                   category_idxs=None if cats is None else torch.from_numpy(
                       cats), top_k=top_k)
    assert got.dtype == torch.int64
    return got.numpy(), want


@pytest.mark.parametrize("case", ["plain", "ties", "no_scores", "category",
                                  "negative_threshold", "top_k"])
def test_nms_keeps_reference_indices(case):
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 60)
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    cats = rng.integers(0, 3, 60).astype(np.int64)
    kw = dict(scores=scores)
    if case == "ties":
        kw["scores"] = np.round(scores * 4) / 4
    elif case == "no_scores":
        kw = {}
    elif case == "category":
        kw["cats"] = cats
    elif case == "negative_threshold":
        kw["cats"] = cats
    elif case == "top_k":
        kw["top_k"] = 7
    thr = -0.1 if case == "negative_threshold" else 0.3
    got, want = _nms_pair(boxes, thr, **kw)
    np.testing.assert_array_equal(got, want)
    # at a negative threshold the first box suppresses every other one
    assert len(want) == 1 if case == "negative_threshold" else len(want) > 1


def test_nms_2000_boxes():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 2000, size=256.0)
    scores = (rng.integers(0, 200, 2000) / 200).astype(np.float32)
    cats = rng.integers(0, 5, 2000).astype(np.int64)
    for c in (None, cats):
        got, want = _nms_pair(boxes, 0.5, scores, c)
        np.testing.assert_array_equal(got, want)
        assert 10 < len(want) < 2000


def test_greedy_keep_is_the_reference_scan():
    """The host scan over a suppression matrix equals the reference's
    fixed-iteration loop (box i kept unless an earlier kept box
    suppresses it) on random matrices."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        over = rng.random((40, 40)) < 0.1
        keep = np.ones(40, bool)
        for i in range(40):
            keep[i] = not np.any(keep[:i] & over[:i, i])
        np.testing.assert_array_equal(tops.greedy_keep(over), keep)


def test_yolo_box():
    rng = np.random.default_rng(6)
    anchors = [10, 13, 16, 30, 33, 23]
    x = rng.standard_normal((2, 3 * (5 + 4), 5, 6)).astype(np.float32)
    img = np.asarray([[160, 192], [150, 170]], np.int64)
    for clip, sxy in ((True, 1.0), (False, 1.05)):
        run_both(lambda x, i: jops.yolo_box(x, i, anchors, 4, 0.3, 32, clip,
                                        sxy),
                 lambda x, i: tops.yolo_box(x, i, anchors, 4, 0.3, 32, clip,
                                        sxy),
                 {"x": x, "i": img}, ("x",))


def test_box_coder_and_generate_proposals_raise_as_the_reference():
    for fn in (lambda m: m.box_coder(None, None, None),
               lambda m: m.generate_proposals()):
        for mod in (jops, tops):
            with pytest.raises(NotImplementedError):
                fn(mod)


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.1),
    dict(score_threshold=0.2, post_threshold=0.3, normalized=False),
    dict(score_threshold=0.05, use_gaussian=True, gaussian_sigma=2.0,
         keep_top_k=15),
    dict(score_threshold=0.1, nms_top_k=10, ties=True)])
def test_matrix_nms(kw):
    kw = dict(kw)
    ties = kw.pop("ties", False)
    rng = np.random.default_rng(9)
    boxes = _boxes(rng, 30, size=1.0)
    scores = rng.uniform(0, 1, (3, 30)).astype(np.float32)
    if ties:
        scores = np.round(scores * 5) / 5
    jout, jidx = jops.matrix_nms(boxes, scores, **kw)
    tout, tidx = tops.matrix_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), **kw)
    assert tidx.dtype == torch.int32 and len(jidx.numpy()) > 3
    np.testing.assert_array_equal(tidx.numpy(), jidx.numpy())
    assert err(tout.numpy(), jout.numpy()) <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], aspect_ratios=[2.0], flip=True, clip=True),
    dict(min_sizes=[4.0, 8.0], max_sizes=[8.0, 16.0], aspect_ratios=[2.0,
         3.0], min_max_aspect_ratios_order=True, steps=(4.0, 4.0))])
def test_prior_box(kw):
    feat = np.zeros((1, 3, 4, 5), np.float32)
    img = np.zeros((1, 3, 32, 40), np.float32)
    jb, jv = jops.prior_box(paddle.to_tensor(feat), paddle.to_tensor(img),
                            **kw)
    tb, tv = tops.prior_box(torch.from_numpy(feat), torch.from_numpy(img),
                            **kw)
    np.testing.assert_array_equal(tb.numpy(), jb.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())


def test_distribute_fpn_proposals():
    rng = np.random.default_rng(10)
    rois = _boxes(rng, 20, size=400.0)
    nums = np.asarray([12, 8], np.int32)
    jr, jrestore, jn = jops.distribute_fpn_proposals(
        paddle.to_tensor(rois), 2, 5, 4, 224, rois_num=paddle.to_tensor(nums))
    tr, trestore, tn = tops.distribute_fpn_proposals(
        torch.from_numpy(rois), 2, 5, 4, 224, rois_num=torch.from_numpy(nums))
    assert len(tr) == len(jr) == 4
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(tn, jn):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(trestore.numpy(), jrestore.numpy())
    assert tops.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4,
                                         224, pixel_offset=True)[2] is None
