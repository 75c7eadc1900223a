"""The port's ``roi_align``, ``roi_pool``, ``ps_roi_pool`` and their
layer wrappers against the reference's (``vision/ops.py``), forward and
the input gradients of ``sum(out * cot)``, within 1e-5 of each tensor's
largest magnitude (``test_torch_vision_ops.py`` has the rest of the
module)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import ops as tops

from torch_vision_common import err, port_on_cpu, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_on_cpu")


@pytest.mark.parametrize("aligned,sr,scale", [(True, -1, 0.5),
                                              (False, 3, 0.25)])
def test_roi_align(aligned, sr, scale):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
    rois = np.asarray([[0, 0, 20, 20], [4, 6, 30, 22], [2, 2, 10, 8],
                       [-3, 1, 33, 25], [5, 5, 5.5, 5.5]], np.float32)
    nums = np.asarray([2, 3], np.int64)
    def call(mod):
        return lambda x, r, n: mod.roi_align(x, r, n, (3, 4), scale, sr,
                                             aligned)
    run_both(call(jops), call(tops), {"x": x, "r": rois, "n": nums},
             ("x", "r"))


def test_roi_pool_and_ps_roi_pool():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    rois = np.asarray([[0, 0, 8, 8], [2, 3, 15, 11], [1, 1, 5, 4],
                       [0, 0, 15, 11], [30, 30, 31, 31]], np.float32)
    nums = np.asarray([2, 3], np.int64)
    run_both(lambda x, r, n: jops.roi_pool(x, r, n, (3, 4), 0.5),
             lambda x, r, n: tops.roi_pool(x, r, n, (3, 4), 0.5),
             {"x": x, "r": rois, "n": nums}, ("x",))
    run_both(lambda x, r, n: jops.ps_roi_pool(x, r, n, 2, 0.5),
             lambda x, r, n: tops.ps_roi_pool(x, r, n, 2, 0.5),
             {"x": x, "r": rois, "n": nums}, ("x",))
    layers = [(jops.RoIAlign(2, 0.5), tops.RoIAlign(2, 0.5)),
              (jops.RoIPool(2, 0.5), tops.RoIPool(2, 0.5)),
              (jops.PSRoIPool(2, 0.5), tops.PSRoIPool(2, 0.5))]
    for jl, tl in layers:
        run_both(lambda x, r, n: jl(x, r, n), lambda x, r, n: tl(x, r, n),
                 {"x": x, "r": rois, "n": nums})
