"""RNN layers. Port of ``paddle_tpu/nn/layer_rnn.py``.

The reference runs each direction of each layer as one ``lax.scan``; here
it is a loop over time steps of torch ops (cuDNN's fused RNN would be a
speed change). The recurrence is the reference's ``_cell_step``: LSTM
gates i, f, g, o; GRU ``n = tanh(i_n + r·h_n)``, ``h = (1 - z)·n +
z·h``. Parameter names are ``weight_ih_l{k}[_reverse]`` and so on.

Kept from the reference: ``sequence_length`` and the inter-layer
``dropout`` are accepted and ignored (every sequence runs its full
length).
"""
import torch

from ..core.dispatch import apply_op
from .layer_base import Layer
from . import initializer as I


def _cell_step(mode, w_ih, w_hh, b_ih, b_hh):
    def simple(x_t, state):
        (h_prev,) = state
        h = torch.tanh(x_t @ w_ih.T + h_prev @ w_hh.T + b_ih + b_hh)
        return (h,), h

    def lstm(x_t, state):
        h_prev, c_prev = state
        gates = x_t @ w_ih.T + h_prev @ w_hh.T + b_ih + b_hh
        i, f, g, o = torch.chunk(gates, 4, -1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c_prev + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return (h, c), h

    def gru(x_t, state):
        (h_prev,) = state
        i_r, i_z, i_n = torch.chunk(x_t @ w_ih.T + b_ih, 3, -1)
        h_r, h_z, h_n = torch.chunk(h_prev @ w_hh.T + b_hh, 3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * h_prev
        return (h,), h

    return {'RNN_TANH': simple, 'LSTM': lstm, 'GRU': gru}[mode]


def _as_states(states):
    if states is None:
        return []
    return list(states) if isinstance(states, (list, tuple)) else [states]


class _RNNBase(Layer):
    MODE = 'RNN_TANH'
    GATES = 1
    STATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ('bidirect', 'bidirectional')
        ndir = 2 if self.bidirect else 1
        self.num_directions = ndir
        g = self.GATES
        k = 1.0 / (hidden_size ** 0.5)
        for layer in range(num_layers):
            for d in range(ndir):
                in_sz = input_size if layer == 0 else hidden_size * ndir
                sfx = '_reverse' if d == 1 else ''
                for n, shape, attr in (
                        ('weight_ih', (g * hidden_size, in_sz),
                         weight_ih_attr),
                        ('weight_hh', (g * hidden_size, hidden_size),
                         weight_hh_attr),
                        ('bias_ih', (g * hidden_size,), bias_ih_attr),
                        ('bias_hh', (g * hidden_size,), bias_hh_attr)):
                    self.add_parameter(
                        f'{n}_l{layer}{sfx}', self.create_parameter(
                            shape, attr,
                            default_initializer=I.Uniform(-k, k)))

    def _weights(self, layer, reverse):
        sfx = '_reverse' if reverse else ''
        return tuple(self._parameters[f'{n}_l{layer}{sfx}']
                     for n in ('weight_ih', 'weight_hh', 'bias_ih',
                               'bias_hh'))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        mode = self.MODE
        nl, ndir, hs = self.num_layers, self.num_directions, self.hidden_size
        time_major = self.time_major
        n_states = self.STATES
        all_params = []
        for layer in range(nl):
            for d in range(ndir):
                all_params.extend(self._weights(layer, d == 1))
        init = _as_states(initial_states)

        def pure(x, init, *flat_w):
            if not time_major:
                x = x.transpose(0, 1)                 # -> [T, B, C]
            B = x.shape[1]
            outs = x
            finals = [[] for _ in range(n_states)]
            for layer in range(nl):
                layer_outs = []
                for d in range(ndir):
                    w = flat_w[4 * (layer * ndir + d):4 * (layer * ndir + d)
                               + 4]
                    step = _cell_step(mode, *w)
                    if init:
                        state = tuple(s[layer * ndir + d] for s in init)
                    else:
                        state = tuple(torch.zeros((B, hs), dtype=x.dtype,
                                                  device=x.device)
                                      for _ in range(n_states))
                    order = range(outs.shape[0])
                    ys = [None] * outs.shape[0]
                    for t in (reversed(order) if d == 1 else order):
                        state, ys[t] = step(outs[t], state)
                    layer_outs.append(torch.stack(ys, 0))
                    for i in range(n_states):
                        finals[i].append(state[i])
                outs = (torch.cat(layer_outs, -1) if ndir == 2
                        else layer_outs[0])
            if not time_major:
                outs = outs.transpose(0, 1)
            return (outs,) + tuple(torch.stack(f, 0) for f in finals)

        res = apply_op(pure, inputs, init, *all_params)
        if n_states == 2:
            return res[0], (res[1], res[2])
        return res[0], res[1]


class SimpleRNN(_RNNBase):
    MODE = 'RNN_TANH'
    GATES = 1
    STATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 activation='tanh', **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)


class LSTM(_RNNBase):
    MODE = 'LSTM'
    GATES = 4
    STATES = 2


class GRU(_RNNBase):
    MODE = 'GRU'
    GATES = 3
    STATES = 1


class _CellBase(Layer):
    MODE = 'RNN_TANH'
    GATES = 1
    STATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.GATES
        k = 1.0 / (hidden_size ** 0.5)
        init = I.Uniform(-k, k)
        self.weight_ih = self.create_parameter(
            (g * hidden_size, input_size), weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            (g * hidden_size, hidden_size), weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            (g * hidden_size,), bias_ih_attr, default_initializer=init)
        self.bias_hh = self.create_parameter(
            (g * hidden_size,), bias_hh_attr, default_initializer=init)

    def forward(self, inputs, states=None):
        n_states, mode, hs = self.STATES, self.MODE, self.hidden_size

        def pure(x, w_ih, w_hh, b_ih, b_hh, *state):
            if not state:
                state = tuple(torch.zeros((x.shape[0], hs), dtype=x.dtype,
                                          device=x.device)
                              for _ in range(n_states))
            new_state, y = _cell_step(mode, w_ih, w_hh, b_ih, b_hh)(x, state)
            return (y,) + tuple(new_state)

        res = apply_op(pure, inputs, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh, *_as_states(states))
        if n_states == 1:
            return res[0], res[1]
        return res[0], tuple(res[1:])


class SimpleRNNCell(_CellBase):
    MODE = 'RNN_TANH'
    GATES = 1
    STATES = 1


class LSTMCell(_CellBase):
    MODE = 'LSTM'
    GATES = 4
    STATES = 2


class GRUCell(_CellBase):
    MODE = 'GRU'
    GATES = 3
    STATES = 1


class RNN(Layer):
    """A cell run over a sequence, one step at a time."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..tensor.manipulation import stack
        axis = 0 if self.time_major else 1
        T = inputs.shape[axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        outs = []
        state = initial_states
        for t in steps:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            y, state = self.cell(x_t, state)
            outs.append(y)
        if self.is_reverse:
            outs = outs[::-1]
        return stack(outs, axis=axis), state


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..tensor.manipulation import concat
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)

