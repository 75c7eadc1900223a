"""Recurrent layers (port of ``paddle_tpu/nn/layers/rnn.py``): the
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` cells, the stacked,
optionally bidirectional ``SimpleRNN``, ``LSTM`` and ``GRU``, and the
generic ``RNN`` over any cell.

The recurrence is the reference's step functions, step by step in
PyTorch (no cuDNN RNN): LSTM gates ``i, f, g, o``, GRU gates ``r, z, c``
with ``r`` applied to ``h @ whh.T + bhh``. A stack projects a layer's
whole input through ``weight_ih`` in one product before its steps, and
adds as the reference does: ``(x @ wih.T + bih) + h @ whh.T + bhh``.
Weights are the reference's layout, ``weight_ih [gates * hidden,
input]`` and ``weight_hh [gates * hidden, hidden]`` in both packages, so
``load_jax_state`` carries them as they are. ``sequence_length``
freezes each example's carry past its length and zeroes those outputs,
in both directions; ``dropout`` applies between stacked layers while
training, drawn from the port's generator of the device (ROADMAP C2,
C43)."""
from __future__ import annotations

import math

import torch

from ... import amp
from ..functional.common import _keep
from ..initializer import Uniform
from ..layer import Layer, LayerList

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNNCellBase", "RNN",
           "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.GATES
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [g * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g * hidden_size], attr=bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g * hidden_size], attr=bias_hh_attr, is_bias=True,
            default_initializer=init)

    def get_initial_states(self, batch, dtype=torch.float32):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=self.weight_ih.device)

    def _weights(self, op, x, states):
        """``x``, the four weights and the states, cast under AMP as the
        reference's op ``op`` casts them."""
        return amp.amp_cast_inputs(op, [x, self.weight_ih, self.weight_hh,
                                        self.bias_ih, self.bias_hh,
                                        *states])


# the steps: ``(params, xw, state) -> (output, new state)`` from the input's
# projection ``xw = x @ wih.T + bih``

def _simple_step(activation):
    act = torch.tanh if activation == "tanh" else torch.relu

    def step(params, xw, h):
        _, whh, bhh = params
        h2 = act(xw + h @ whh.T + bhh)
        return h2, h2
    return step


def _lstm_step(params, xw, state):
    _, whh, bhh = params
    h, c = state
    i, f, g, o = torch.chunk(xw + h @ whh.T + bhh, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, (h2, c2)


def _gru_step(params, xw, h):
    _, whh, bhh = params
    xr, xz, xc = torch.chunk(xw, 3, dim=-1)
    hr, hz, hc = torch.chunk(h @ whh.T + bhh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    cand = torch.tanh(xc + r * hc)
    h2 = (1 - z) * cand + z * h
    return h2, h2


def _zeros(x, hidden):
    return torch.zeros((x.shape[-2], hidden), dtype=x.dtype, device=x.device)


class SimpleRNNCell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, **kw)
        self.activation = activation

    def forward(self, inputs, states=None):
        x, wih, whh, bih, bhh, *st = self._weights(
            "simple_rnn_cell", inputs, [] if states is None else [states])
        h = st[0] if st else _zeros(x, self.hidden_size)
        return _simple_step(self.activation)((wih, whh, bhh),
                                             x @ wih.T + bih, h)


class LSTMCell(RNNCellBase):
    GATES = 4

    def forward(self, inputs, states=None):
        x, wih, whh, bih, bhh, *st = self._weights(
            "lstm_cell", inputs, [] if states is None else list(states))
        if not st:
            st = [_zeros(x, self.hidden_size)] * 2
        return _lstm_step((wih, whh, bhh), x @ wih.T + bih, tuple(st))


class GRUCell(RNNCellBase):
    GATES = 3

    def forward(self, inputs, states=None):
        x, wih, whh, bih, bhh, *st = self._weights(
            "gru_cell", inputs, [] if states is None else [states])
        h = st[0] if st else _zeros(x, self.hidden_size)
        return _gru_step((wih, whh, bhh), x @ wih.T + bih, h)


_CELLS = {"SimpleRNN": SimpleRNNCell, "LSTM": LSTMCell, "GRU": GRUCell}


def _scan(step, params, xw, init, valid):
    """The steps over ``xw [T, B, G]`` from ``init``: ``(final state,
    outputs [T, B, H])``; where ``valid [T, B]`` is False the carry stays
    and the output is 0."""
    carry, ys = init, []
    for t in range(xw.shape[0]):
        h2, new = step(params, xw[t], carry)
        if valid is not None:
            keep = valid[t][:, None]
            if isinstance(new, tuple):
                new = tuple(torch.where(keep, a, b)
                            for a, b in zip(new, carry))
            else:
                new = torch.where(keep, new, carry)
            h2 = torch.where(keep, h2, 0.0)
        carry = new
        ys.append(h2)
    return carry, torch.stack(ys, 0)


class _RNNBase(Layer):
    MODE = "SimpleRNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        ndirs = 2 if self.bidirect else 1
        cells = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * ndirs
            for _ in range(ndirs):
                kw = dict(weight_ih_attr=weight_ih_attr,
                          weight_hh_attr=weight_hh_attr,
                          bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
                if self.MODE == "SimpleRNN":
                    kw["activation"] = activation
                cells.append(_CELLS[self.MODE](in_sz, hidden_size, **kw))
        self.cells = LayerList(cells)

    def _step_fn(self):
        if self.MODE == "SimpleRNN":
            return _simple_step(self.activation)
        return _lstm_step if self.MODE == "LSTM" else _gru_step

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``inputs [B, T, F]`` (``[T, B, F]`` when ``time_major``);
        ``initial_states [layers * dirs, B, H]`` (a pair for LSTM);
        ``sequence_length [B]``. Returns ``(outputs, final states)``, the
        states ``[layers * dirs, B, H]`` (a pair for LSTM)."""
        ndirs = 2 if self.bidirect else 1
        step = self._step_fn()
        is_lstm = self.MODE == "LSTM"
        nl = self.num_layers
        states = ([] if initial_states is None else
                  list(initial_states) if is_lstm else [initial_states])
        weights = [w for cell in self.cells
                   for w in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                             cell.bias_hh)]
        x, *rest = amp.amp_cast_inputs(self.MODE.lower(),
                                       [inputs, *weights, *states])
        weights, states = rest[:len(weights)], rest[len(weights):]
        xs = x if self.time_major else x.transpose(0, 1)   # [T, B, F]
        valid = None
        if sequence_length is not None:
            lens = torch.as_tensor(sequence_length, device=xs.device)
            valid = (torch.arange(xs.shape[0], device=xs.device)[:, None]
                     < lens[None, :].to(torch.int32))
        use_drop = self.dropout > 0.0 and self.training and nl > 1
        hs, cs = [], []
        for layer in range(nl):
            outs = []
            for d in range(ndirs):
                ci = layer * ndirs + d
                wih, whh, bih, bhh = weights[4 * ci:4 * ci + 4]
                seq = xs if d == 0 else torch.flip(xs, [0])
                if states:
                    init = ((states[0][ci].to(seq.dtype),
                             states[1][ci].to(seq.dtype)) if is_lstm
                            else states[0][ci].to(seq.dtype))
                else:
                    z = _zeros(seq, self.hidden_size)
                    init = (z, z) if is_lstm else z
                vmask = (None if valid is None else
                         valid if d == 0 else torch.flip(valid, [0]))
                final, ys = _scan(step, (wih, whh, bhh), seq @ wih.T + bih,
                                  init, vmask)
                outs.append(ys if d == 0 else torch.flip(ys, [0]))
                if is_lstm:
                    hs.append(final[0])
                    cs.append(final[1])
                else:
                    hs.append(final)
            xs = outs[0] if ndirs == 1 else torch.cat(outs, -1)
            if use_drop and layer < nl - 1:
                keep = _keep(xs.shape, self.dropout, xs.device)
                xs = torch.where(keep, xs / (1.0 - self.dropout),
                                 0.0).to(xs.dtype)
        out = xs if self.time_major else xs.transpose(0, 1)
        h = torch.stack(hs, 0)
        return (out, (h, torch.stack(cs, 0))) if is_lstm else (out, h)


class SimpleRNN(_RNNBase):
    MODE = "SimpleRNN"


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class RNN(Layer):
    """Runs any cell over the steps (reversed with ``is_reverse``), one
    call a step: ``(outputs, final state)``. ``sequence_length`` is taken
    and not applied, as in the reference."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        steps = xs.shape[0]
        order = (range(steps - 1, -1, -1) if self.is_reverse
                 else range(steps))
        state = initial_states
        outs = [None] * steps
        for t in order:
            outs[t], state = self.cell(xs[t], state)
        stacked = torch.stack(outs, 0)
        if not self.time_major:
            stacked = stacked.transpose(0, 1)
        return stacked, state
