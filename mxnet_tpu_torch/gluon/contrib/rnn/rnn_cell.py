"""``gluon.contrib.rnn``'s cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell``,
one dropout mask a sequence, and ``LSTMPCell``, the LSTM with a projected
recurrent state.  Tensors or NDArrays in and out, as the cells of
``gluon.rnn``."""
from __future__ import annotations

import torch

from ...rnn.rnn_cell import (BidirectionalCell, HybridRecurrentCell,
                             ModifierCell, _uniform_like)
from .... import autograd
from ....context import resolve_device

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Dropout of the inputs, the first state and the outputs with one mask
    for every step of a sequence (Gal and Ghahramani), drawn at the first
    step after a ``reset``."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or \
            not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support variational state dropout. " \
            "Please add VariationalDropoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_mask(self, like, p):
        keep = (_uniform_like(like) > p).to(torch.float32)
        return keep / torch.full((), 1 - p, dtype=torch.float32,
                                 device=keep.device)

    def _forward(self, inputs, states):
        if autograd.is_training():
            if self.drop_inputs:
                if self.drop_inputs_mask is None:
                    self.drop_inputs_mask = self._initialize_mask(
                        inputs, self.drop_inputs)
                inputs = inputs * self.drop_inputs_mask
            if self.drop_states:
                if self.drop_states_mask is None:
                    self.drop_states_mask = self._initialize_mask(
                        states[0], self.drop_states)
                states = [states[0] * self.drop_states_mask] \
                    + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if autograd.is_training() and self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = self._initialize_mask(
                    output, self.drop_outputs)
            output = output * self.drop_outputs_mask
        return output, next_states


class LSTMPCell(HybridRecurrentCell):
    """An LSTM whose output and recurrent state are projected from
    ``hidden_size`` down to ``projection_size`` (Sak et al.); the cell
    state keeps ``hidden_size``."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def _shape_hook(self, x, *args):
        self._reg_params["i2h_weight"].shape = (4 * self._hidden_size,
                                                x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        in_g, forget_g, cell_g, out_g = F.SliceChannel(
            i2h + h2h, num_outputs=4, axis=1)
        c = (F.sigmoid(forget_g) * states[1]
             + F.sigmoid(in_g) * F.Activation(cell_g, act_type="tanh"))
        hidden = F.sigmoid(out_g) * F.Activation(c, act_type="tanh")
        proj = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                num_hidden=self._projection_size)
        return proj, [proj, c]
