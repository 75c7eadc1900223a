"""The port's recurrent layers (``paddle_tpu_torch/nn/layers/rnn.py``)
against the reference's (``paddle_tpu/nn/layers/rnn.py``) on shared
weights: the cells with and without states, stacked and bidirectional
``SimpleRNN`` / ``LSTM`` / ``GRU``, ``time_major``, initial states,
``sequence_length`` in both directions, and the generic ``RNN`` over a
cell. Outputs, final states and the gradients of the inputs, the states
and every weight of ``sum(out * cot)`` within 1e-5 of each tensor's
largest magnitude. Also: ``load_jax_state`` carries ``weight_ih`` /
``weight_hh`` untransposed (``[gates * hidden, in]`` in both packages),
and dropout's own semantics (between stacked layers, while training,
from the port's generator: ROADMAP C2, C43)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn

from torch_vision_common import (check_grads, err, model_pair,  # noqa: F401
                                 npy, port_on_cpu, run_both)

pytestmark = pytest.mark.usefixtures("port_on_cpu")

B, T, IN, H = 3, 7, 5, 6


def _hold(jl, tl, inputs, diff, call):
    """Both layers on ``inputs`` through ``call(layer, **tensors)``:
    outputs, input gradients and every weight's gradient."""
    run_both(lambda **kw: call(jl, **kw), lambda **kw: call(tl, **kw),
             inputs, diff)
    check_grads(jl, tl)


@pytest.mark.parametrize("cell,kw,states", [
    ("SimpleRNNCell", {}, False), ("SimpleRNNCell", dict(activation="relu"),
                                   True),
    ("LSTMCell", {}, False), ("LSTMCell", {}, True),
    ("GRUCell", {}, False), ("GRUCell", {}, True)])
def test_cells(cell, kw, states):
    jl, tl = model_pair(lambda: getattr(jnn, cell)(IN, H, **kw),
                        lambda: getattr(tnn, cell)(IN, H, **kw))
    rng = np.random.default_rng(0)
    inputs = {"x": rng.standard_normal((B, IN)).astype(np.float32)}
    if states:
        inputs["h"] = rng.standard_normal((B, H)).astype(np.float32)
        if cell == "LSTMCell":
            inputs["c"] = rng.standard_normal((B, H)).astype(np.float32)

    def call(layer, x, h=None, c=None):
        st = None if h is None else ((h, c) if c is not None else h)
        return layer(x, st)
    _hold(jl, tl, inputs, tuple(inputs), call)


#: (mode, layers, direction, time_major, initial states, sequence_length)
STACKS = [
    ("SimpleRNN", 1, "forward", False, False, False),
    ("SimpleRNN", 2, "bidirect", True, True, True),
    ("LSTM", 2, "bidirectional", False, True, True),
    ("LSTM", 1, "forward", True, False, True),
    ("GRU", 2, "forward", False, True, False),
    ("GRU", 1, "bidirect", False, False, True),
]


@pytest.mark.parametrize("mode,nl,direction,tm_,init,lens", STACKS)
def test_stacks(mode, nl, direction, tm_, init, lens):
    kw = dict(num_layers=nl, direction=direction, time_major=tm_)
    if mode == "SimpleRNN":
        kw["activation"] = "relu" if nl == 1 else "tanh"
    jl, tl = model_pair(lambda: getattr(jnn, mode)(IN, H, **kw),
                        lambda: getattr(tnn, mode)(IN, H, **kw))
    rng = np.random.default_rng(nl)
    ndirs = 2 if direction != "forward" else 1
    shape = (T, B, IN) if tm_ else (B, T, IN)
    inputs = {"x": rng.standard_normal(shape).astype(np.float32)}
    if init:
        inputs["h"] = rng.standard_normal((nl * ndirs, B, H)).astype(
            np.float32)
        if mode == "LSTM":
            inputs["c"] = rng.standard_normal((nl * ndirs, B, H)).astype(
                np.float32)
    if lens:
        inputs["n"] = np.asarray([T, 4, 1], np.int64)

    def call(layer, x, h=None, c=None, n=None):
        st = None if h is None else ((h, c) if c is not None else h)
        return layer(x, st, n)
    outs = run_both(lambda **k: call(jl, **k), lambda **k: call(tl, **k),
                    inputs, tuple(k for k in inputs if k != "n"))
    check_grads(jl, tl)
    if lens:
        # past each length the outputs are 0 in both directions
        out = npy(outs[0])
        out = out.transpose(1, 0, 2) if tm_ else out
        assert not out[2, 1:].any() and not out[1, 4:].any()
        assert out[1, :4].any()


def test_generic_rnn_over_a_cell():
    for reverse in (False, True):
        jc, tc = model_pair(lambda: jnn.GRUCell(IN, H),
                            lambda: tnn.GRUCell(IN, H))
        jl = jnn.RNN(jc, is_reverse=reverse)
        tl = tnn.RNN(tc, is_reverse=reverse)
        x = np.random.default_rng(3).standard_normal((B, T, IN)).astype(
            np.float32)
        run_both(lambda x: jl(x), lambda x: tl(x), {"x": x}, ("x",))
        check_grads(jc, tc)


def test_weights_convert_without_transpose():
    jl, tl = model_pair(lambda: jnn.LSTM(IN, H, num_layers=2),
                        lambda: tnn.LSTM(IN, H, num_layers=2))
    jstate = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert jstate["cells.0.weight_ih"].shape == (4 * H, IN)
    assert tuple(tl.cells[0].weight_ih.shape) == (4 * H, IN)
    tstate = pt.jax_layout(tl)
    assert list(tstate) == list(jstate)
    for k in jstate:
        np.testing.assert_array_equal(tstate[k], jstate[k])


def test_dropout_semantics():
    """Dropout acts between stacked layers while training only: a
    one-layer stack and eval mode give the undropped output; training
    with two layers changes it, and one port seed gives one result; in
    eval the stack equals the reference's (which draws from its JAX key
    stream while training, C2)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, T, IN)).astype(np.float32))
    pt.seed(7)
    two = tnn.GRU(IN, H, num_layers=2, dropout=0.5)
    plain = tnn.GRU(IN, H, num_layers=2)
    plain.set_state_dict(two.state_dict())
    two.eval()
    np.testing.assert_array_equal(npy(two(x)[0]), npy(plain(x)[0]))
    two.train()
    pt.seed(11)
    a = npy(two(x)[0])
    pt.seed(11)
    b = npy(two(x)[0])
    np.testing.assert_array_equal(a, b)
    assert err(a, npy(plain(x)[0])) > 1e-3
    one = tnn.GRU(IN, H, dropout=0.5)
    one_plain = tnn.GRU(IN, H)
    one_plain.set_state_dict(one.state_dict())
    np.testing.assert_array_equal(npy(one(x)[0]), npy(one_plain(x)[0]))
    jl = jnn.GRU(IN, H, num_layers=2, dropout=0.5)
    jl.eval()
    pt.load_jax_state(plain, {k: v.numpy() for k, v in
                              jl.state_dict().items()})
    assert err(npy(plain(x)[0]),
               npy(jl(paddle.to_tensor(x.numpy()))[0])) <= 1e-5
