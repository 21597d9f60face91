"""Convolutional recurrent cells, ConvRNN, ConvLSTM and ConvGRU in 1, 2
and 3 dimensions (counterpart of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``, after Shi et al.): the
cells of ``gluon.rnn`` with every product a convolution, run through the
port's ``Convolution`` op (cuDNN on the card).  ``h2h`` convolves the state
with "same" padding (odd kernels only), so the state keeps its spatial
size; channel-first layouts only, as in the JAX package.
"""
from __future__ import annotations

from ....base import MXNetError
from ....context import resolve_device
from ...nn.conv_layers import _pair as _tuple
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


class _ConvCellBase(HybridRecurrentCell):
    """Shared machinery: shapes, conv parameters, the two convolutions."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix, params, device=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        if conv_layout not in ("NCW", "NCHW", "NCDHW")[dims - 1:dims]:
            raise MXNetError("conv_layout %r unsupported: channel-first "
                             "('NC...') only on this build" % (conv_layout,))
        self._dims = dims
        self._input_shape = tuple(int(s) for s in input_shape)
        self._hidden_channels = int(hidden_channels)
        self._activation = activation
        self._i2h_kernel = _tuple(i2h_kernel, dims)
        self._h2h_kernel = _tuple(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("h2h_kernel must be odd (same-padded "
                                 "recurrence); got %r" % (self._h2h_kernel,))
        self._i2h_pad = _tuple(i2h_pad, dims)
        self._i2h_dilate = _tuple(i2h_dilate, dims)
        self._h2h_dilate = _tuple(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))

        in_c = self._input_shape[0]
        # stride-1 conv output spatial size
        self._state_spatial = tuple(
            (x + 2 * p - d * (k - 1) - 1) + 1
            for x, p, d, k in zip(self._input_shape[1:], self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        ng = self._num_gates
        h = self._hidden_channels
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(ng * h, in_c) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(ng * h, h) + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ng * h,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ng * h,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial
        return [{"shape": shape, "__layout__": "NC" + "DHW"[3 - self._dims:]}
                ] * self._num_states

    def _convs(self, F, inputs, state, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        ng = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=ng * self._hidden_channels)
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=ng * self._hidden_channels)
        return i2h, h2h

    def _act(self, F, x):
        act = self._activation
        if callable(act):
            return act(x)
        return F.Activation(x, act_type=act)


class _ConvRNNCell(_ConvCellBase):
    _num_gates = 1
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        output = self._act(F, i2h + h2h)
        return output, [output]


class _ConvLSTMCell(_ConvCellBase):
    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        gates = i2h + h2h
        in_g, forget_g, cell_g, out_g = F.SliceChannel(
            gates, num_outputs=4, axis=1)
        i = F.sigmoid(in_g)
        f = F.sigmoid(forget_g)
        c = f * states[1] + i * self._act(F, cell_g)
        o = F.sigmoid(out_g)
        h = o * self._act(F, c)
        return h, [h, c]


class _ConvGRUCell(_ConvCellBase):
    _num_gates = 3
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        # reset/update gates see i2h+h2h; the candidate's recurrent term is
        # gated by r BEFORE the sum (the reference/cuDNN GRU formulation),
        # so i2h and h2h stay separate rather than pre-summed
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_c = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_c = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(i2h_r + h2h_r)
        z = F.sigmoid(i2h_z + h2h_z)
        cand = self._act(F, i2h_c + r * h2h_c)
        out = (1 - z) * cand + z * states[0]
        return out, [out]


def _make_cell(base, dims, default_layout, alias_name, doc):
    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None, h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                     conv_layout=default_layout, activation="tanh",
                     prefix=None, params=None, device=None):
            super().__init__(
                input_shape=input_shape, hidden_channels=hidden_channels,
                i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                i2h_pad=i2h_pad, i2h_dilate=i2h_dilate, h2h_dilate=h2h_dilate,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer,
                dims=dims, conv_layout=conv_layout, activation=activation,
                prefix=prefix, params=params, device=device)

    Cell.__name__ = Cell.__qualname__ = alias_name
    Cell.__doc__ = doc
    return Cell


_DOC = ("%dD convolutional %s cell. input_shape is channel-first "
        "(C, spatial...); the state's spatial size follows the i2h "
        "convolution.")

Conv1DRNNCell = _make_cell(_ConvRNNCell, 1, "NCW", "Conv1DRNNCell", _DOC % (1, "RNN"))
Conv2DRNNCell = _make_cell(_ConvRNNCell, 2, "NCHW", "Conv2DRNNCell", _DOC % (2, "RNN"))
Conv3DRNNCell = _make_cell(_ConvRNNCell, 3, "NCDHW", "Conv3DRNNCell", _DOC % (3, "RNN"))
Conv1DLSTMCell = _make_cell(_ConvLSTMCell, 1, "NCW", "Conv1DLSTMCell", _DOC % (1, "LSTM"))
Conv2DLSTMCell = _make_cell(_ConvLSTMCell, 2, "NCHW", "Conv2DLSTMCell", _DOC % (2, "LSTM"))
Conv3DLSTMCell = _make_cell(_ConvLSTMCell, 3, "NCDHW", "Conv3DLSTMCell", _DOC % (3, "LSTM"))
Conv1DGRUCell = _make_cell(_ConvGRUCell, 1, "NCW", "Conv1DGRUCell", _DOC % (1, "GRU"))
Conv2DGRUCell = _make_cell(_ConvGRUCell, 2, "NCHW", "Conv2DGRUCell", _DOC % (2, "GRU"))
Conv3DGRUCell = _make_cell(_ConvGRUCell, 3, "NCDHW", "Conv3DGRUCell", _DOC % (3, "GRU"))
