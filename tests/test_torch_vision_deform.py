"""The port's ``deform_conv2d`` and ``DeformConv2D`` against the
reference's (``vision/ops.py``): forward and the gradients of x, the
offsets, the mask, the weight and the bias, within 1e-5 of each
tensor's largest magnitude (``test_torch_vision_ops.py`` has the rest
of the module)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import ops as tops

from torch_vision_common import err, port_on_cpu, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_on_cpu")


@pytest.mark.parametrize("groups,dg,use_mask", [(1, 1, False), (2, 2, True)])
def test_deform_conv2d(groups, dg, use_mask):
    rng = np.random.default_rng(7)
    n, cin, h, w, cout, k = 2, 4, 7, 8, 6, 3
    stride, pad, dil = (1, 2), 1, (1, 2)
    ho = (h + 2 * pad - (k - 1) - 1) // 1 + 1
    wo = (w + 2 * pad - 2 * (k - 1) - 1) // 2 + 1
    arrays = {
        "x": rng.standard_normal((n, cin, h, w)).astype(np.float32),
        "off": (rng.standard_normal((n, 2 * dg * k * k, ho, wo)) * 1.7
                ).astype(np.float32),
        "wt": rng.standard_normal((cout, cin // groups, k, k)).astype(
            np.float32),
        "b": rng.standard_normal(cout).astype(np.float32)}
    if use_mask:
        arrays["m"] = rng.uniform(0, 1, (n, dg * k * k, ho, wo)).astype(
            np.float32)

    def call(mod):
        def fn(x, off, wt, b, m=None):
            return mod.deform_conv2d(x, off, wt, b, stride, pad, dil, dg,
                                     groups, m)
        return fn
    run_both(call(jops), call(tops), arrays, tuple(arrays))


def test_deform_conv_layer():
    rng = np.random.default_rng(8)
    paddle.seed(0)
    jl = jops.DeformConv2D(4, 6, 3, padding=1)
    tl = tops.DeformConv2D(4, 6, 3, padding=1)
    pt.load_jax_state(tl, {k: v.numpy() for k, v in jl.state_dict().items()})
    x = rng.standard_normal((1, 4, 5, 5)).astype(np.float32)
    off = rng.standard_normal((1, 18, 5, 5)).astype(np.float32)
    run_both(lambda x, o: jl(x, o), lambda x, o: tl(x, o), {"x": x, "o": off},
             ("x", "o"))
