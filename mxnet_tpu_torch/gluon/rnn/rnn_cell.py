"""Gluon's recurrent cells (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``): ``RNNCell``, ``LSTMCell`` and
``GRUCell``, the ``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
``ResidualCell`` and ``BidirectionalCell`` around them, and ``unroll``.

A cell is called as ``cell(inputs, states) -> (output, new_states)``, one
step.  Its arithmetic is the JAX cell's ``hybrid_forward``, with ``F`` the
registered ops over tensors (``ndarray.register.tensor_ops``).  Called
with NDArrays (``inputs`` and the ``states`` list), a cell or ``unroll``
returns NDArrays; with tensors, tensors.  As in the JAX package, a cell's
calls do not go through a CachedOp (``hybridize`` has no effect on them),
and random draws (dropout, zoneout) take one ``random.next_key()`` each,
so one ``mx.random.seed`` gives both packages the same masks.  A default
begin state inside ``unroll`` is made on the inputs' device.
"""
from __future__ import annotations

import torch

from ..block import Block, HybridBlock
from ... import autograd
from ... import ndarray as nd
from ...context import resolve_device
from ...ndarray.ndarray import NDArray
from ...ndarray.register import tensor_ops

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


def _is_nd(x):
    if isinstance(x, (list, tuple)):
        return bool(x) and isinstance(x[0], NDArray)
    return isinstance(x, NDArray)


def _wrap(x, as_nd):
    if not as_nd:
        return x
    if isinstance(x, (list, tuple)):
        return [_wrap(v, True) for v in x]
    return NDArray(x)


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, begin_state, inputs, batch_size):
    """Tensors: the given states, or the cell's zeros on the inputs'
    device."""
    if begin_state is None:
        device = (inputs if isinstance(inputs, torch.Tensor)
                  else inputs[0]).device
        begin_state = cell.begin_state(batch_size=batch_size, ctx=device)
    return [_tensor(s) for s in begin_state]


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """``(inputs, time axis, batch size)``: a merged tensor split into
    per-step tensors (``merge=False``), or per-step tensors stacked
    (``merge=True``)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, torch.Tensor):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            in_axis = in_layout.find("T") if in_layout is not None else axis
            inputs = list(torch.unbind(inputs, in_axis))
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = torch.stack(list(inputs), dim=axis)
    return inputs, axis, batch_size


def _tensors_in(inputs):
    return _tensor(inputs) if not isinstance(inputs, (list, tuple)) \
        else [_tensor(i) for i in inputs]


class RecurrentCell(Block):
    """The base of the recurrent cells: ``state_info``, ``begin_state``,
    ``unroll`` and the one-step call."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before another unroll."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if hasattr(cell, "reset"):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """One ``func(shape, **kwargs)`` a state (default ``nd.zeros`` on
        the current context, or ``ctx=``)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            extra = {k: v for k, v in kwargs.items()
                     if k not in ("shape", "__layout__")}
            states.append(func(info["shape"], **extra))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times over ``inputs`` (a merged array
        in ``layout``, or one array a step).  Outputs past each
        ``valid_length`` are zeros.  Returns ``(outputs, states)``, the
        outputs merged along T when ``merge_outputs``."""
        as_nd = _is_nd(inputs)
        inputs, axis, batch_size = _format_sequence(
            length, _tensors_in(inputs), layout, False)
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if valid_length is not None:
            masked = tensor_ops.SequenceMask(
                torch.stack(outputs), _tensor(valid_length),
                use_sequence_length=True, axis=0)
            outputs = list(torch.unbind(masked, 0))
        if merge_outputs:
            outputs = torch.stack(outputs, dim=layout.find("T"))
        return _wrap(outputs, as_nd), _wrap(list(states), as_nd)

    def forward(self, inputs, states):
        return self._forward(inputs, states)

    def _forward(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        self._counter += 1
        as_nd = _is_nd(inputs)
        output, new_states = self._forward(
            _tensor(inputs), [_tensor(s) for s in states])
        return _wrap(output, as_nd), _wrap(list(new_states), as_nd)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell written as ``hybrid_forward(F, inputs, states, **params)``,
    run with ``F`` the ops over tensors and its parameters' tensors."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def _forward(self, inputs, states):
        if self._lazy_params:
            self._finish_deferred(inputs)
        params = {k: getattr(self, k) for k in self._reg_params}
        return self.hybrid_forward(tensor_ops, inputs, states, **params)

    def hybrid_forward(self, F, x, states, **params):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """The parameters of RNN/LSTM/GRU cells: ``i2h``/``h2h`` weights and
    biases for ``gates`` gates, the input size deferred."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params, device):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._gates * hidden_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(g, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(g, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(g,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(g,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def _shape_hook(self, x, *args):
        self._reg_params["i2h_weight"].shape = (
            self._gates * self._hidden_size, x.shape[-1])


class RNNCell(_GatedCell):
    """``out = act(i2h(x) + h2h(h))``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None, device=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         device)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """The LSTM step, gates in the order i, f, c, o."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, device=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         device)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = F.SliceChannel(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.Activation(gates[0], act_type="sigmoid")
        forget_gate = F.Activation(gates[1], act_type="sigmoid")
        in_transform = F.Activation(gates[2], act_type="tanh")
        out_gate = F.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """The GRU step, MXNet's (cuDNN's): the reset gate scales ``h2h``'s
    candidate term after its bias."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, device=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         device)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp \
            + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(), **kwargs)

    def _forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._modules.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __len__(self):
        return len(self._modules)


class DropoutCell(HybridRecurrentCell):
    """Dropout of the input, as the op ``Dropout`` draws it (one key a
    step)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float)), "rate must be a number"
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell around ``base_cell``, whose parameters it shares; the base
    cell is then called only through it."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=nd.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


def _uniform_like(like):
    """``nd.random.uniform(0, 1, like.shape)`` on ``like``'s device (one
    key)."""
    return nd.random.uniform(0, 1, shape=tuple(like.shape),
                             ctx=like.device)._data


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al.): in training, each output and state unit
    keeps its previous value with probability ``zoneout_*``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def _forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states

        def mask(p, like):
            return (_uniform_like(like) > p).to(torch.float32)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = torch.zeros(next_output.shape,
                                      device=next_output.device)
        if self.zoneout_outputs > 0:
            m = mask(self.zoneout_outputs, next_output)
            output = m * next_output + (1 - m) * prev_output
        else:
            output = next_output
        if self.zoneout_states > 0:
            new_states = []
            for ns, s in zip(next_states, states):
                m = mask(self.zoneout_states, ns)
                new_states.append(m * ns + (1 - m) * s)
        else:
            new_states = next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (Wu et al.)."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def _forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed, their
    outputs concatenated; unrolled only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        as_nd = _is_nd(inputs)
        inputs, axis, batch_size = _format_sequence(
            length, _tensors_in(inputs), layout, False)
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        l_cell, r_cell = self._modules.values()
        n_l = len(l_cell.state_info(batch_size))
        valid = None if valid_length is None else _tensor(valid_length)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid)
        r_outputs = list(reversed(r_outputs))
        outputs = [torch.cat([l_o, r_o], dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = torch.stack(outputs, dim=layout.find("T"))
        return _wrap(outputs, as_nd), _wrap(l_states + r_states, as_nd)
