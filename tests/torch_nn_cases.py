"""The functional case table that ``tests/test_torch_nn_functional.py``
runs through the reference and the port on the CPU, and that
``chip_smoke.py`` phase 8(a) runs through the port on the card against
its CPU run: one case (or more) per op of the reference registry's
``functional`` module and per alias it records there. A case is ``fn(F,
t)``, with ``F`` a functional module and ``t`` the inputs as that
package's tensors; its inputs are drawn from a numpy generator seeded
from the case's id. This module imports numpy only."""
import zlib
from collections import namedtuple

import numpy as np

#: forward: max |port - reference| / max(|reference|, 1)
FWD_TOL = 2e-5
#: gradient: max |port - reference| / max(|reference grad|, 1)
GRAD_TOL = 1e-4


Case = namedtuple("Case", "op fn inputs tag grad nograd tol gtol")


def C(op, fn, inputs, tag="", grad=True, nograd=(), tol=FWD_TOL,
      gtol=GRAD_TOL):
    return Case(op, fn, inputs, tag, grad, tuple(nograd), tol, gtol)


def f32(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype(np.float32)


def uni(lo, hi, *shape):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def ints(lo, hi, *shape):
    return lambda r: r.randint(lo, hi, shape).astype(np.int64)


def const(a):
    return lambda r: np.asarray(a)


def X(*shape, scale=1.0):
    return {"x": f32(*shape, scale=scale)}


def _sdpa_mask(r):
    return r.rand(2, 1, 6, 6) > 0.3


def _csr(r):
    """A per-(batch, head) CSR pattern over 4 positions, every row
    nonempty but the last head's row 2."""
    offs, cols = [], []
    for b in range(1):
        for h in range(2):
            row_off, c = [0], []
            for i in range(4):
                keep = [] if (h == 1 and i == 2) else sorted(
                    r.choice(4, r.randint(1, 4), replace=False))
                c += keep
                row_off.append(len(c))
            offs.append(row_off)
            cols.append(c + [0] * (16 - len(c)))
    return (np.array(offs, np.int64).reshape(1, 2, 5),
            np.array(cols, np.int64).reshape(1, 2, 16))


def _ctc_lp(r):
    return np.log(r.dirichlet(np.ones(5), (6, 2))).astype(np.float32)


CASES = [
    # -- activations ------------------------------------------------------
    C("relu", lambda F, t: F.relu(t["x"]), X(3, 7)),
    C("relu_", lambda F, t: F.relu_(t["x"] * 1.0), X(3, 7), grad=False),
    C("relu6", lambda F, t: F.relu6(t["x"]), X(3, 7, scale=4)),
    C("gelu", lambda F, t: F.gelu(t["x"]), X(3, 7)),
    C("gelu", lambda F, t: F.gelu(t["x"], approximate=True), X(3, 7),
      "tanh"),
    C("silu", lambda F, t: F.silu(t["x"]), X(3, 7)),
    C("swish", lambda F, t: F.swish(t["x"]), X(3, 7)),
    C("sigmoid", lambda F, t: F.sigmoid(t["x"]), X(3, 7)),
    C("hardsigmoid", lambda F, t: F.hardsigmoid(t["x"]), X(3, 7, scale=4)),
    C("hardswish", lambda F, t: F.hardswish(t["x"]), X(3, 7, scale=4)),
    C("hardtanh", lambda F, t: F.hardtanh(t["x"], -0.5, 0.8), X(3, 7)),
    C("tanh", lambda F, t: F.tanh(t["x"]), X(3, 7)),
    C("tanhshrink", lambda F, t: F.tanhshrink(t["x"]), X(3, 7)),
    C("leaky_relu", lambda F, t: F.leaky_relu(t["x"], 0.2), X(3, 7)),
    C("elu", lambda F, t: F.elu(t["x"], 0.7), X(3, 7)),
    C("celu", lambda F, t: F.celu(t["x"], 1.3), X(3, 7)),
    C("selu", lambda F, t: F.selu(t["x"]), X(3, 7)),
    C("softplus", lambda F, t: F.softplus(t["x"], 2.0, 3.0),
      X(3, 7, scale=3)),
    C("softshrink", lambda F, t: F.softshrink(t["x"], 0.3), X(3, 7)),
    C("hardshrink", lambda F, t: F.hardshrink(t["x"], 0.3), X(3, 7)),
    C("softsign", lambda F, t: F.softsign(t["x"]), X(3, 7)),
    C("mish", lambda F, t: F.mish(t["x"]), X(3, 7, scale=3)),
    C("softmax", lambda F, t: F.softmax(t["x"], axis=0), X(3, 7)),
    C("log_softmax", lambda F, t: F.log_softmax(t["x"]), X(3, 7)),
    C("maxout", lambda F, t: F.maxout(t["x"], 2, axis=1), X(2, 6, 3, 3)),
    C("glu", lambda F, t: F.glu(t["x"]), X(3, 8)),
    C("prelu", lambda F, t: F.prelu(t["x"], t["w"]),
      {"x": f32(2, 4, 3, 3), "w": uni(0.1, 0.5, 4)}),
    C("prelu", lambda F, t: F.prelu(t["x"], t["w"]),
      {"x": f32(2, 4, 3, 3), "w": uni(0.1, 0.5, 1)}, "scalar"),
    C("rrelu", lambda F, t: F.rrelu(t["x"], 0.1, 0.3, training=False),
      X(3, 7), "eval"),
    C("log_sigmoid", lambda F, t: F.log_sigmoid(t["x"]), X(3, 7, scale=3)),
    C("logsigmoid", lambda F, t: F.logsigmoid(t["x"]), X(3, 7)),
    # -- linear, embedding, one_hot ----------------------------------------
    C("linear", lambda F, t: F.linear(t["x"], t["w"], t["b"]),
      {"x": f32(3, 5), "w": f32(5, 4), "b": f32(4)}),
    C("embedding", lambda F, t: F.embedding(t["i"], t["w"], padding_idx=1),
      {"i": ints(0, 10, 2, 5), "w": f32(10, 4)}),
    C("one_hot", lambda F, t: F.one_hot(t["i"], 5), {"i": ints(0, 5, 6)},
      grad=False),
    # -- dropout: deterministic modes --------------------------------------
    C("dropout", lambda F, t: F.dropout(t["x"], 0.4, training=False),
      X(3, 7), "eval"),
    C("dropout", lambda F, t: F.dropout(t["x"], 0.0), X(3, 7), "p0"),
    C("dropout", lambda F, t: F.dropout(t["x"], 1.0), X(3, 7), "p1",
      grad=False),
    C("dropout", lambda F, t: F.dropout(t["x"], 0.4, training=False,
                                        mode="downscale_in_infer"),
      X(3, 7), "downscale_eval"),
    C("dropout2d", lambda F, t: F.dropout2d(t["x"], 0.4, training=False),
      X(2, 3, 4, 4)),
    C("dropout3d", lambda F, t: F.dropout3d(t["x"], 0.0), X(2, 3, 2, 2, 2)),
    C("alpha_dropout", lambda F, t: F.alpha_dropout(t["x"], 0.3,
                                                    training=False), X(3, 7)),
    C("feature_alpha_dropout",
      lambda F, t: F.feature_alpha_dropout(t["x"], 0.0), X(2, 3, 4)),
    # -- convolutions -------------------------------------------------------
    C("conv1d", lambda F, t: F.conv1d(t["x"], t["w"], t["b"], stride=2,
                                      padding=1),
      {"x": f32(2, 3, 10), "w": f32(4, 3, 3), "b": f32(4)}),
    C("conv1d", lambda F, t: F.conv1d(t["x"], t["w"], padding="SAME",
                                      data_format="NLC"),
      {"x": f32(2, 9, 3), "w": f32(4, 3, 3)}, "nlc_same"),
    C("conv2d", lambda F, t: F.conv2d(t["x"], t["w"], t["b"], stride=2,
                                      padding=[1, 0, 2, 1]),
      {"x": f32(2, 3, 9, 9), "w": f32(4, 3, 3, 3), "b": f32(4)},
      "asym"),
    C("conv2d", lambda F, t: F.conv2d(t["x"], t["w"], padding="SAME",
                                      stride=2, dilation=2, groups=3),
      {"x": f32(2, 3, 9, 8), "w": f32(6, 1, 3, 3)}, "same_groups"),
    C("conv2d", lambda F, t: F.conv2d(t["x"], t["w"], t["b"], padding=1,
                                      data_format="NHWC"),
      {"x": f32(2, 6, 6, 3), "w": f32(4, 3, 3, 3), "b": f32(4)}, "nhwc"),
    C("conv3d", lambda F, t: F.conv3d(t["x"], t["w"], t["b"], padding=1),
      {"x": f32(1, 2, 5, 5, 5), "w": f32(3, 2, 3, 3, 3), "b": f32(3)}),
    C("conv2d_transpose",
      lambda F, t: F.conv2d_transpose(t["x"], t["w"], t["b"], stride=2,
                                      padding=1, output_padding=1),
      {"x": f32(2, 4, 5, 5), "w": f32(4, 3, 3, 3), "b": f32(3)}),
    C("conv2d_transpose",
      lambda F, t: F.conv2d_transpose(t["x"], t["w"], stride=2, padding=1,
                                      groups=2, dilation=2,
                                      output_size=[12, 12]),
      {"x": f32(1, 4, 5, 5), "w": f32(4, 2, 3, 3)}, "groups_size"),
    C("conv1d_transpose",
      lambda F, t: F.conv1d_transpose(t["x"], t["w"], t["b"], stride=3,
                                      padding=2),
      {"x": f32(2, 3, 6), "w": f32(3, 2, 4), "b": f32(2)}),
    C("conv3d_transpose",
      lambda F, t: F.conv3d_transpose(t["x"], t["w"], stride=2, padding=1),
      {"x": f32(1, 2, 3, 3, 3), "w": f32(2, 2, 3, 3, 3)}),
    # -- pooling ----------------------------------------------------------
    C("max_pool1d", lambda F, t: F.max_pool1d(t["x"], 3, 2, 1),
      X(2, 3, 11)),
    C("max_pool2d", lambda F, t: F.max_pool2d(t["x"], 3, 2, 1),
      X(2, 3, 9, 9)),
    C("max_pool2d", lambda F, t: F.max_pool2d(t["x"], 3, 2, ceil_mode=True),
      X(2, 3, 8, 8), "ceil"),
    C("max_pool2d", lambda F, t: F.max_pool2d(t["x"], 2, 2, 0,
                                              data_format="NHWC"),
      X(2, 6, 6, 3), "nhwc"),
    C("max_pool2d", lambda F, t: F.max_pool2d(t["x"], 3, 2, 1,
                                              return_mask=True),
      X(2, 3, 7, 7), "mask"),
    C("max_pool3d", lambda F, t: F.max_pool3d(t["x"], 2, 2, "SAME"),
      X(1, 2, 5, 5, 5)),
    C("avg_pool1d", lambda F, t: F.avg_pool1d(t["x"], 3, 2, 1,
                                              exclusive=False), X(2, 3, 11)),
    C("avg_pool2d", lambda F, t: F.avg_pool2d(t["x"], 3, 2, 1),
      X(2, 3, 9, 9)),
    C("avg_pool2d", lambda F, t: F.avg_pool2d(t["x"], 3, 2, 1,
                                              ceil_mode=True,
                                              exclusive=False),
      X(2, 3, 8, 8), "ceil_inclusive"),
    C("avg_pool2d", lambda F, t: F.avg_pool2d(t["x"], 2, 2,
                                              divisor_override=3),
      X(2, 3, 6, 6), "divisor"),
    C("avg_pool3d", lambda F, t: F.avg_pool3d(t["x"], 3, 2, 1),
      X(1, 2, 5, 5, 5)),
    C("adaptive_avg_pool1d", lambda F, t: F.adaptive_avg_pool1d(t["x"], 4),
      X(2, 3, 8)),
    C("adaptive_avg_pool2d", lambda F, t: F.adaptive_avg_pool2d(t["x"],
                                                                (3, 4)),
      X(2, 3, 7, 9), "bins"),
    C("adaptive_avg_pool2d", lambda F, t: F.adaptive_avg_pool2d(t["x"], 1),
      X(2, 3, 4, 4), "global"),
    C("adaptive_avg_pool3d", lambda F, t: F.adaptive_avg_pool3d(t["x"],
                                                                (2, 3, 2)),
      X(1, 2, 4, 6, 5)),
    C("adaptive_max_pool2d", lambda F, t: F.adaptive_max_pool2d(t["x"],
                                                                (4, 2)),
      X(2, 3, 8, 8)),
    C("max_pool1d_with_index",
      lambda F, t: F.max_pool1d_with_index(t["x"], 3, 2, 1), X(2, 3, 9)),
    C("max_pool2d_with_index",
      lambda F, t: F.max_pool2d_with_index(t["x"], 2, 2), X(2, 3, 6, 6)),
    C("max_unpool1d", lambda F, t: F.max_unpool1d(
        *F.max_pool1d(t["x"], 2, 2, return_mask=True), 2, 2), X(2, 3, 8)),
    C("max_unpool2d", lambda F, t: F.max_unpool2d(
        *F.max_pool2d(t["x"], 2, 2, return_mask=True), 2, 2), X(2, 3, 6, 6)),
    C("max_unpool3d", lambda F, t: F.max_unpool3d(
        *F.max_pool3d(t["x"], 2, 2, return_mask=True), 2, 2,
        output_size=[5, 5, 5]), X(1, 2, 5, 5, 5)),
    # -- padding, resizing, rearranging ------------------------------------
    C("pad", lambda F, t: F.pad(t["x"], [1, 2, 0, 1], mode="reflect"),
      X(2, 3, 4, 5), "reflect"),
    C("pad", lambda F, t: F.pad(t["x"], [1, 2, 2, 0], value=0.5),
      X(2, 3, 4, 5), "constant"),
    C("zeropad2d", lambda F, t: F.zeropad2d(t["x"], [1, 0, 2, 1]),
      X(1, 2, 3, 3)),
    C("interpolate", lambda F, t: F.interpolate(t["x"], size=(9, 4)),
      X(1, 2, 5, 7), "nearest"),
    C("interpolate", lambda F, t: F.interpolate(t["x"], scale_factor=2,
                                                mode="bilinear"),
      X(1, 2, 4, 5), "bilinear_up"),
    C("interpolate", lambda F, t: F.interpolate(t["x"], size=(3, 4),
                                                mode="bilinear"),
      X(1, 2, 7, 9), "bilinear_down"),
    C("interpolate", lambda F, t: F.interpolate(t["x"], size=(7, 5),
                                                mode="bilinear",
                                                align_corners=True),
      X(1, 2, 4, 3), "align_corners"),
    C("interpolate", lambda F, t: F.interpolate(t["x"], size=(8, 10),
                                                mode="bicubic"),
      X(1, 2, 5, 6), "bicubic_up"),
    C("interpolate", lambda F, t: F.interpolate(t["x"], size=7,
                                                mode="linear",
                                                data_format="NCW"),
      X(2, 3, 4), "linear_1d"),
    C("upsample", lambda F, t: F.upsample(t["x"], scale_factor=3),
      X(1, 2, 3, 2)),
    C("pixel_shuffle", lambda F, t: F.pixel_shuffle(t["x"], 2),
      X(1, 8, 3, 3)),
    C("pixel_unshuffle", lambda F, t: F.pixel_unshuffle(t["x"], 3),
      X(1, 2, 6, 6)),
    C("channel_shuffle", lambda F, t: F.channel_shuffle(t["x"], 3),
      X(1, 6, 2, 2)),
    C("channel_shuffle", lambda F, t: F.channel_shuffle(
        t["x"], 2, data_format="NHWC"), X(1, 2, 2, 6), "nhwc"),
    C("unfold", lambda F, t: F.unfold(t["x"], [2, 3], strides=2,
                                      paddings=1), X(2, 3, 6, 6)),
    C("unfold_channels", lambda F, t: F.unfold_channels(t["x"], 2),
      X(1, 2, 4, 4)),
    C("fold", lambda F, t: F.fold(t["x"], [5, 5], 2), X(2, 12, 16)),
    C("affine_grid", lambda F, t: F.affine_grid(t["th"], [2, 1, 4, 5]),
      {"th": f32(2, 2, 3)}),
    C("affine_grid", lambda F, t: F.affine_grid(t["th"], [2, 1, 3, 4],
                                                align_corners=False),
      {"th": f32(2, 2, 3)}, "centers"),
    C("grid_sample", lambda F, t: F.grid_sample(t["x"], t["g"]),
      {"x": f32(1, 2, 5, 6), "g": uni(-1.1, 1.1, 1, 3, 4, 2)}),
    C("grid_sample", lambda F, t: F.grid_sample(
        t["x"], t["g"], mode="nearest", padding_mode="border",
        align_corners=False),
      {"x": f32(1, 2, 5, 6), "g": uni(-1.1, 1.1, 1, 3, 4, 2)}, "nearest"),
    C("temporal_shift", lambda F, t: F.temporal_shift(t["x"], 2),
      X(4, 8, 2, 2)),
    # -- norms -------------------------------------------------------------
    C("layer_norm", lambda F, t: F.layer_norm(t["x"], 4, t["w"], t["b"]),
      {"x": f32(2, 3, 4), "w": f32(4), "b": f32(4)}),
    C("rms_norm", lambda F, t: F.rms_norm(t["x"], t["w"]),
      {"x": f32(3, 8), "w": f32(8)}),
    C("batch_norm", lambda F, t: (
        F.batch_norm(t["x"], t["rm"], t["rv"], t["w"], t["b"],
                     training=True), t["rm"], t["rv"]),
      {"x": f32(4, 3, 5, 5), "rm": f32(3), "rv": uni(0.5, 2.0, 3),
       "w": f32(3), "b": f32(3)}, "train", nograd=("rm", "rv")),
    C("batch_norm", lambda F, t: F.batch_norm(
        t["x"], t["rm"], t["rv"], t["w"], t["b"], data_format="NHWC"),
      {"x": f32(2, 3, 3, 4), "rm": f32(4), "rv": uni(0.5, 2.0, 4),
       "w": f32(4), "b": f32(4)}, "eval_nhwc", nograd=("rm", "rv")),
    C("instance_norm", lambda F, t: F.instance_norm(t["x"], weight=t["w"],
                                                    bias=t["b"]),
      {"x": f32(2, 3, 4, 4), "w": f32(3), "b": f32(3)}),
    C("group_norm", lambda F, t: F.group_norm(t["x"], 3, 1e-5, t["w"],
                                              t["b"]),
      {"x": f32(2, 6, 3, 3), "w": f32(6), "b": f32(6)}),
    C("group_norm", lambda F, t: F.group_norm(t["x"], 2,
                                              data_format="NHWC"),
      X(2, 3, 3, 4), "nhwc"),
    C("local_response_norm", lambda F, t: F.local_response_norm(t["x"], 3),
      X(2, 6, 3, 3)),
    C("normalize", lambda F, t: F.normalize(t["x"]), X(3, 5)),
    C("normalize", lambda F, t: F.normalize(t["x"], p=1, axis=0), X(3, 5),
      "l1"),
    # -- attention ----------------------------------------------------------
    C("scaled_dot_product_attention",
      lambda F, t: F.scaled_dot_product_attention(t["q"], t["k"], t["v"],
                                                  is_causal=True),
      {"q": f32(2, 6, 4, 8), "k": f32(2, 6, 2, 8), "v": f32(2, 6, 2, 8)}),
    C("scaled_dot_product_attention",
      lambda F, t: F.scaled_dot_product_attention(
          t["q"], t["k"], t["v"], attn_mask=t["m"]),
      {"q": f32(2, 6, 2, 8), "k": f32(2, 6, 2, 8), "v": f32(2, 6, 2, 8),
       "m": _sdpa_mask}, "mask"),
    C("sparse_attention", lambda F, t: F.sparse_attention(
        t["q"], t["k"], t["v"], t["off"], t["col"]),
      {"q": f32(1, 2, 4, 8), "k": f32(1, 2, 4, 8), "v": f32(1, 2, 4, 8),
       "off": lambda r: _csr(r)[0], "col": lambda r: _csr(r)[1]}),
    # -- misc ----------------------------------------------------------------
    C("label_smooth", lambda F, t: F.label_smooth(t["y"], epsilon=0.2),
      {"y": uni(0, 1, 4, 5)}),
    C("bilinear", lambda F, t: F.bilinear(t["a"], t["b"], t["w"], t["c"]),
      {"a": f32(3, 4), "b": f32(3, 5), "w": f32(2, 4, 5), "c": f32(2)}),
    C("class_center_sample", lambda F, t: F.class_center_sample(t["y"], 10,
                                                                3),
      {"y": const([1, 7, 3, 3, 9, 1, 5, 0])}, grad=False),
    C("sequence_mask", lambda F, t: F.sequence_mask(t["n"], 6),
      {"n": const([2, 6, 0])}, grad=False),
    C("sequence_mask", lambda F, t: F.sequence_mask(t["n"], dtype="float32"),
      {"n": const([2, 5, 1])}, "maxlen", grad=False),
    C("gather_tree", lambda F, t: F.gather_tree(t["i"], t["p"]),
      {"i": ints(0, 9, 4, 2, 3), "p": ints(0, 3, 4, 2, 3)}, grad=False),
    C("pairwise_distance", lambda F, t: F.pairwise_distance(t["a"], t["b"]),
      {"a": f32(4, 5), "b": f32(4, 5)}),
    # -- losses ---------------------------------------------------------------
    C("cross_entropy", lambda F, t: F.cross_entropy(t["x"], t["y"]),
      {"x": f32(6, 4), "y": const([0, 3, -100, 1, 2, 2])}),
    C("cross_entropy", lambda F, t: F.cross_entropy(
        t["x"], t["y"], weight=t["w"], label_smoothing=0.1),
      {"x": f32(6, 4), "y": const([[0], [3], [1], [1], [2], [2]]),
       "w": uni(0.5, 2, 4)}, "weight_smooth"),
    C("cross_entropy", lambda F, t: F.cross_entropy(
        t["x"], t["y"], soft_label=True, reduction="sum"),
      {"x": f32(5, 4), "y": lambda r: r.dirichlet(np.ones(4), 5)
       .astype(np.float32)}, "soft"),
    C("cross_entropy", lambda F, t: F.cross_entropy(
        t["x"], t["y"], use_softmax=False, reduction="none"),
      {"x": lambda r: r.dirichlet(np.ones(4), 5).astype(np.float32),
       "y": ints(0, 4, 5)}, "probs"),
    C("softmax_with_cross_entropy", lambda F, t: F.softmax_with_cross_entropy(
        t["x"], t["y"], return_softmax=True),
      {"x": f32(5, 4), "y": ints(0, 4, 5, 1)}),
    C("nll_loss", lambda F, t: F.nll_loss(t["x"], t["y"], weight=t["w"]),
      {"x": f32(5, 4), "y": const([0, 3, 1, -100, 2]),
       "w": uni(0.5, 2, 4)}),
    C("nll_loss", lambda F, t: F.nll_loss(t["x"], t["y"], reduction="sum"),
      {"x": f32(2, 3, 4, 4), "y": ints(0, 3, 2, 4, 4)}, "spatial"),
    C("mse_loss", lambda F, t: F.mse_loss(t["a"], t["b"]),
      {"a": f32(3, 4), "b": f32(3, 4)}),
    C("l1_loss", lambda F, t: F.l1_loss(t["a"], t["b"], "sum"),
      {"a": f32(3, 4), "b": f32(3, 4)}),
    C("smooth_l1_loss", lambda F, t: F.smooth_l1_loss(t["a"], t["b"],
                                                      delta=0.5),
      {"a": f32(3, 4), "b": f32(3, 4)}),
    C("huber_loss", lambda F, t: F.huber_loss(t["a"], t["b"], 0.7, "none"),
      {"a": f32(3, 4), "b": f32(3, 4)}),
    C("gaussian_nll_loss", lambda F, t: F.gaussian_nll_loss(
        t["a"], t["b"], t["v"], full=True),
      {"a": f32(3, 4), "b": f32(3, 4), "v": uni(0.2, 2, 3, 4)}),
    C("binary_cross_entropy", lambda F, t: F.binary_cross_entropy(
        t["p"], t["y"], t["w"]),
      {"p": uni(0.05, 0.95, 3, 4), "y": lambda r: (r.rand(3, 4) > 0.5)
       .astype(np.float32), "w": uni(0.5, 2, 3, 4)}),
    C("binary_cross_entropy_with_logits",
      lambda F, t: F.binary_cross_entropy_with_logits(
          t["z"], t["y"], t["w"], pos_weight=t["pw"]),
      {"z": f32(3, 4, scale=3), "y": lambda r: (r.rand(3, 4) > 0.5)
       .astype(np.float32), "w": uni(0.5, 2, 3, 4), "pw": uni(0.5, 2, 4)}),
    C("binary_cross_entropy_with_logits",
      lambda F, t: F.binary_cross_entropy_with_logits(t["z"], t["y"]),
      {"z": f32(3, 4, scale=3), "y": uni(0, 1, 3, 4)}, "plain"),
    C("kl_div", lambda F, t: F.kl_div(t["lp"], t["y"], "batchmean"),
      {"lp": lambda r: np.log(r.dirichlet(np.ones(4), 3)).astype(np.float32),
       "y": lambda r: r.dirichlet(np.ones(4), 3).astype(np.float32)}),
    C("kl_div", lambda F, t: F.kl_div(t["lp"], t["y"], "sum",
                                      log_target=True),
      {"lp": f32(3, 4), "y": f32(3, 4)}, "log_target"),
    C("cosine_similarity", lambda F, t: F.cosine_similarity(t["a"], t["b"]),
      {"a": f32(3, 5), "b": f32(3, 5)}),
    C("cosine_embedding_loss", lambda F, t: F.cosine_embedding_loss(
        t["a"], t["b"], t["y"], margin=0.1),
      {"a": f32(4, 5), "b": f32(4, 5), "y": const([1, -1, -1, 1])}),
    C("margin_ranking_loss", lambda F, t: F.margin_ranking_loss(
        t["a"], t["b"], t["y"], 0.2),
      {"a": f32(6), "b": f32(6), "y": const(
          np.array([1, -1, 1, 1, -1, -1], np.float32))}),
    C("hinge_embedding_loss", lambda F, t: F.hinge_embedding_loss(
        t["a"], t["y"]),
      {"a": f32(6), "y": const(np.array([1, -1, 1, -1, -1, 1],
                                        np.float32))}),
    C("triplet_margin_loss", lambda F, t: F.triplet_margin_loss(
        t["a"], t["p"], t["n"], swap=True),
      {"a": f32(4, 5), "p": f32(4, 5), "n": f32(4, 5)}),
    C("triplet_margin_with_distance_loss",
      lambda F, t: F.triplet_margin_with_distance_loss(t["a"], t["p"],
                                                       t["n"]),
      {"a": f32(4, 5), "p": f32(4, 5), "n": f32(4, 5)}),
    C("triplet_margin_with_distance_loss",
      lambda F, t: F.triplet_margin_with_distance_loss(
          t["a"], t["p"], t["n"], swap=True, margin=2.0,
          distance_function=F.pairwise_distance),
      {"a": f32(4, 5), "p": f32(4, 5), "n": f32(4, 5)}, "distance_fn"),
    C("sigmoid_focal_loss", lambda F, t: F.sigmoid_focal_loss(
        t["z"], t["y"], t["n"]),
      {"z": f32(3, 4), "y": lambda r: (r.rand(3, 4) > 0.5)
       .astype(np.float32), "n": uni(1, 3, 1)}),
    C("square_error_cost", lambda F, t: F.square_error_cost(t["a"], t["b"]),
      {"a": f32(3, 4), "b": f32(3, 4)}),
    C("log_loss", lambda F, t: F.log_loss(t["p"], t["y"]),
      {"p": uni(0.1, 0.9, 4, 1), "y": lambda r: (r.rand(4, 1) > 0.5)
       .astype(np.float32)}),
    C("ctc_loss", lambda F, t: F.ctc_loss(t["lp"], t["y"], t["il"], t["ll"]),
      {"lp": _ctc_lp, "y": const([[1, 2, 2], [3, 1, 0]]),
       "il": const([6, 5]), "ll": const([3, 2])}),
    C("ctc_loss", lambda F, t: F.ctc_loss(t["lp"], t["y"], t["il"], t["ll"],
                                          reduction="sum",
                                          norm_by_times=True),
      {"lp": f32(6, 2, 5), "y": const([[4, 4, 1], [2, 0, 0]]),
       "il": const([6, 4]), "ll": const([3, 1])}, "sum"),
    C("npair_loss", lambda F, t: F.npair_loss(t["a"], t["p"], t["y"]),
      {"a": f32(4, 5), "p": f32(4, 5), "y": const([1, 2, 1, 3])}),
    C("dice_loss", lambda F, t: F.dice_loss(t["p"], t["y"]),
      {"p": lambda r: r.dirichlet(np.ones(4), 3).astype(np.float32),
       "y": ints(0, 4, 3, 1)}),
    C("margin_cross_entropy", lambda F, t: F.margin_cross_entropy(
        t["c"], t["y"], return_softmax=True, scale=8.0),
      {"c": uni(-0.9, 0.9, 4, 6), "y": ints(0, 6, 4)}),
    C("adaptive_log_softmax_with_loss",
      lambda F, t: F.adaptive_log_softmax_with_loss(
          t["x"], t["y"], t["hw"], [[t["a1"], t["a2"]], [t["b1"], t["b2"]]],
          [4, 7, 10], head_bias=t["hb"]),
      {"x": f32(5, 8), "y": const([0, 5, 9, 3, 7]), "hw": f32(8, 6),
       "hb": f32(6), "a1": f32(8, 2), "a2": f32(2, 3), "b1": f32(8, 1),
       "b2": f32(1, 3)}),
    C("adaptive_log_softmax_log_prob",
      lambda F, t: F.adaptive_log_softmax_log_prob(
          t["x"], t["hw"], [[t["a1"], t["a2"]]], [4, 7]),
      {"x": f32(5, 8), "hw": f32(8, 5), "a1": f32(8, 2), "a2": f32(2, 3)}),
    C("poisson_nll_loss", lambda F, t: F.poisson_nll_loss(t["x"], t["y"]),
      {"x": f32(3, 4), "y": uni(0, 3, 3, 4)}),
    C("poisson_nll_loss", lambda F, t: F.poisson_nll_loss(
        t["x"], t["y"], log_input=False, full=True),
      {"x": uni(0.2, 3, 3, 4), "y": uni(0.5, 4, 3, 4)}, "full"),
    C("soft_margin_loss", lambda F, t: F.soft_margin_loss(t["x"], t["y"]),
      {"x": f32(3, 4, scale=3), "y": lambda r: np.sign(r.randn(3, 4))
       .astype(np.float32)}),
    C("multi_label_soft_margin_loss",
      lambda F, t: F.multi_label_soft_margin_loss(t["x"], t["y"], t["w"]),
      {"x": f32(3, 4), "y": lambda r: (r.rand(3, 4) > 0.5)
       .astype(np.float32), "w": uni(0.5, 2, 4)}),
    C("multi_margin_loss", lambda F, t: F.multi_margin_loss(
        t["x"], t["y"], p=2, margin=0.5, weight=t["w"]),
      {"x": f32(4, 5), "y": ints(0, 5, 4), "w": uni(0.5, 2, 5)}),
    C("hsigmoid_loss", lambda F, t: F.hsigmoid_loss(
        t["x"], t["y"], 6, t["w"], t["b"]),
      {"x": f32(4, 5), "y": ints(0, 6, 4), "w": f32(5, 5), "b": f32(5, 1)}),
    C("hsigmoid_loss", lambda F, t: F.hsigmoid_loss(
        t["x"], t["y"], 4, t["w"], path_table=t["pt"], path_code=t["pc"]),
      {"x": f32(3, 5), "y": ints(0, 4, 3), "w": f32(4, 5),
       "pt": const([[0, 1, -1], [0, 2, 3], [1, -1, -1]]),
       "pc": const([[1, 0, 0], [0, 1, 1], [1, 0, 0]])}, "path_table"),
]

#: ops held only statistically (their every mode draws)
RANDOM_ONLY = {"gumbel_softmax"}


def case_id(case):
    return case.op + (f"[{case.tag}]" if case.tag else "")


def case_arrays(case):
    rng = np.random.RandomState(zlib.crc32(case_id(case).encode()))
    out = {}
    for k, make in case.inputs.items():
        a = np.asarray(make(rng))
        out[k] = a.astype(np.float32) if a.dtype == np.float64 else a
    return out


def flat_outputs(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in flat_outputs(o)]
    return [out]
