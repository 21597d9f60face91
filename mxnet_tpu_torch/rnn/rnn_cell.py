"""The legacy symbolic RNN cells (counterpart of
``mxnet_tpu/rnn/rnn_cell.py``): ``RNNParams``, ``BaseRNNCell``, the
RNN/LSTM/GRU cells, ``FusedRNNCell`` over the ``RNN`` op, and the
stacking and modifier cells, building ``mx.sym`` graphs step by step as
the reference's bucketing examples write them.

As in the JAX package, ``unroll`` makes its default begin states with the
``_rnn_state_like`` op, which reads the batch size off the input symbol
(the reference resolves a state's 0 batch dimension by shape inference at
bind time); ``begin_state(func=sym.Variable)`` feeds states as inputs.

``FusedRNNCell.unpack_weights``/``pack_weights`` move between the fused
blob and the unfused cells' per-gate names on torch tensors (the JAX
package writes through views of an NDArray); the arrays and their order
are the same.
"""
from __future__ import annotations

import math
import warnings

from contextlib import contextmanager

import torch

from .. import symbol
from .. import ndarray
from .. import initializer as init
from ..base import numeric_types
from ..ndarray.ndarray import NDArray


def _as_tensor(a):
    """An NDArray's tensor (detached), or a tensor of an array-like."""
    return a._data.detach() if isinstance(a, NDArray) else torch.as_tensor(a)


class _ContainerCellMixin:
    """Shared plumbing for cells that hold child cells in ``self._cells``
    (SequentialRNNCell, BidirectionalCell): the state surface is the
    concatenation of the children's, and weight (un)packing threads through
    each child in order."""

    def _absorb_cell_params(self, cell):
        """Merge a child's parameter dict into the container's.

        A container constructed with an explicit ``params`` is the single
        owner: children must NOT also have been given one (ownership would
        be ambiguous), and the container's dict is pushed down into the
        child before the merge."""
        if self._override_cell_params:
            if not cell._own_params:
                raise ValueError(
                    "%s got an explicit params dict, so its child cells "
                    "must not: construct the children without params="
                    % type(self).__name__)
            # push down the container's ORIGINAL dict, not the running
            # merge — otherwise a later child would also receive every
            # earlier child's parameters
            if not hasattr(self, "_own_params_snapshot"):
                self._own_params_snapshot = dict(self.params._params)
            cell.params._params.update(self._own_params_snapshot)
        self.params._params.update(cell.params._params)

    def _thread_weights(self, args, method):
        for cell in self._cells:
            args = getattr(cell, method)(args)
        return args

    def unpack_weights(self, args):
        return self._thread_weights(args, "unpack_weights")

    def pack_weights(self, args):
        return self._thread_weights(args, "pack_weights")

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        self._assert_not_modified()
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def _default_begin_state(self, first_input, time_major_ref=False):
        return [s for c in self._cells
                for s in c._default_begin_state(first_input, time_major_ref)]


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Convert between a merged (N,T,C)/(T,N,C) symbol and a per-step list.

    Returns (inputs, axis) where axis is the time axis of the given layout.
    """
    if inputs is None:
        raise ValueError("unroll(inputs=...) is required for the symbolic "
                         "cell API")
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    merged_in = isinstance(inputs, symbol.Symbol)
    if merged_in and merge is False:
        # split the merged sequence into per-step symbols along time
        if len(inputs.list_outputs()) != 1:
            raise ValueError("unroll doesn't allow grouped symbols as inputs")
        inputs = list(symbol.SliceChannel(inputs, axis=in_axis,
                                          num_outputs=length, squeeze_axis=1))
    elif not merged_in:
        if length is not None and len(inputs) != length:
            raise ValueError("expected %d per-step inputs, got %d"
                             % (length, len(inputs)))
        if merge is True:
            # stack the per-step symbols into one (.., T, ..) tensor
            steps = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*steps, dim=axis)
            in_axis = axis
    if isinstance(inputs, symbol.Symbol) and axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNParams(object):
    """Container for cell parameter symbols, shared between cells by name."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        """The parameter symbol ``prefix+name``, created on first use."""
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract symbolic RNN cell (reference rnn_cell.py BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._prefix = prefix
        self._params = params if params is not None else RNNParams(prefix)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset step counters before building another graph."""
        self._init_counter = -1
        self._counter = -1
        for cell in getattr(self, "_cells", []):
            cell.reset()

    def __call__(self, inputs, states):
        """Unroll one step: returns (output, new_states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def _assert_not_modified(self):
        assert not self._modified, \
            "After applying modifier cells (e.g. DropoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial state symbols; one per state_info entry.

        With the default ``func=symbol.zeros`` the state shapes keep their 0
        batch dim and only resolve inside ``unroll`` (see module docstring);
        pass ``func=symbol.Variable`` to feed states as inputs."""
        self._assert_not_modified()
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            opts = dict(kwargs, **(info or {}))
            states.append(func(name=name, **opts))
        return states

    def _default_begin_state(self, first_input, time_major_ref=False):
        """Default zero states whose batch dim is read off an input symbol."""
        ref_axis = 1 if time_major_ref else 0
        states = []
        for info in self.state_info:
            self._init_counter += 1
            states.append(symbol._rnn_state_like(
                first_input, shape=info["shape"], ref_axis=ref_axis,
                name="%sbegin_state_%d" % (self._prefix, self._init_counter)))
        return states

    def unpack_weights(self, args):
        """Split fused i2h/h2h matrices into per-gate entries."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            weight = args.pop("%s%s_weight" % (self._prefix, group))
            bias = args.pop("%s%s_bias" % (self._prefix, group))
            for j, gate in enumerate(self._gate_names):
                args["%s%s%s_weight" % (self._prefix, group, gate)] = \
                    weight[j * h:(j + 1) * h].copy()
                args["%s%s%s_bias" % (self._prefix, group, gate)] = \
                    bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights."""
        args = args.copy()
        if not self._gate_names:
            return args
        for group in ("i2h", "h2h"):
            name = "%s%s" % (self._prefix, group)
            args[name + "_weight"] = ndarray.concat(
                *[args.pop("%s%s_weight" % (name, g)) for g in self._gate_names],
                dim=0)
            args[name + "_bias"] = ndarray.concat(
                *[args.pop("%s%s_bias" % (name, g)) for g in self._gate_names],
                dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell for ``length`` steps over ``inputs``."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._default_begin_state(inputs[0])

        states = begin_state
        outputs = []
        for t in range(length):
            output, states = self(inputs[t], states)
            outputs.append(output)

        outputs, _ = _normalize_sequence(length, outputs, layout, merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: out = act(i2h(x) + h2h(h))."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell with i/f/c/o gate order (reference LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        # forget_bias folds into the i2h bias initialization so the forget
        # gate starts open (Jozefowicz et al. 2015)
        self._iB = self.params.get(
            "i2h_bias", init=init.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name="%sslice" % name)
        in_gate = symbol.Activation(gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_trans = symbol.Activation(gates[2], act_type="tanh",
                                     name="%sc" % name)
        out_gate = symbol.Activation(gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, cuDNN-style r/z/o gating (reference GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%s_i2h" % name)
        h2h = symbol.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%s_h2h" % name)
        i2h_r, i2h_z, i2h_o = symbol.SliceChannel(
            i2h, num_outputs=3, name="%s_i2h_slice" % name)
        h2h_r, h2h_z, h2h_o = symbol.SliceChannel(
            h2h, num_outputs=3, name="%s_h2h_slice" % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name="%s_r_act" % name)
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name="%s_z_act" % name)
        h_trans = symbol.Activation(i2h_o + reset * h2h_o, act_type="tanh",
                                    name="%s_h_act" % name)
        next_h = (1.0 - update) * h_trans + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence cell over the fused ``RNN`` op, whose blob keeps the
    reference's (cuDNN's) packed layout, so unpack_weights/pack_weights
    interoperate with the unfused cells' parameter names."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get(
            "parameters", init=init.FusedRNN(None, num_hidden, num_layers,
                                             mode, bidirectional, forget_bias))

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _weight_names(self, li, lh):
        """``(name, shape)`` of every array in the packed blob, in packing
        order (cuDNN's, the reference's fused layout): all weight matrices
        first, per (layer, direction) every gate's i2h then every gate's
        h2h, then all bias vectors in the same nesting."""
        b = len(self._directions)

        def each(groups):
            for layer in range(self._num_layers):
                for d in self._directions:
                    for group in groups:
                        for gate in self._gate_names:
                            yield layer, d, group, gate

        out = []
        for layer, d, group, gate in each(("i2h", "h2h")):
            cols = (li if layer == 0 else b * lh) if group == "i2h" else lh
            out.append(("%s%s%d_%s%s_weight" % (self._prefix, d, layer,
                                                 group, gate), (lh, cols)))
        for layer, d, group, gate in each(("i2h", "h2h")):
            out.append(("%s%s%d_%s%s_bias" % (self._prefix, d, layer, group,
                                               gate), (lh,)))
        return out

    def unpack_weights(self, args):
        args = args.copy()
        arr = args.pop(self._parameter.name)
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        num_input = (arr.size // b // h // m
                     - (self._num_layers - 1) * (h + b * h + 2) - h - 2)
        flat = _as_tensor(arr).reshape(-1)
        cursor = 0
        for name, shape in self._weight_names(num_input, h):
            n = math.prod(shape)
            args[name] = NDArray(flat[cursor:cursor + n].reshape(shape)
                                 .clone())
            cursor += n
        if cursor != flat.numel():
            raise ValueError("FusedRNNCell parameter vector has %d elements; "
                             "layout needs %d" % (flat.numel(), cursor))
        return args

    def pack_weights(self, args):
        args = args.copy()
        h = self._num_hidden
        w0 = _as_tensor(args["%sl0_i2h%s_weight"
                             % (self._prefix, self._gate_names[0])])
        parts = [_as_tensor(args.pop(name)).reshape(-1).to(w0.device,
                                                           w0.dtype)
                 for name, _ in self._weight_names(w0.shape[1], h)]
        args[self._parameter.name] = NDArray(torch.cat(parts))
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            warnings.warn("NTC layout detected. Consider using "
                          "TNC for FusedRNNCell for faster speed")
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        else:
            assert axis == 0, "Unsupported layout %s" % layout
        if begin_state is None:
            begin_state = self._default_begin_state(inputs, time_major_ref=True)

        states = {"state": begin_state[0]}
        if self._mode == "lstm":
            states["state_cell"] = begin_state[1]

        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **states)

        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]

        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        outputs, _ = _normalize_sequence(length, outputs, layout, merge_outputs)
        return outputs, states

    def unfuse(self):
        """Equivalent stack of unfused cells (steppable)."""
        stack = SequentialRNNCell()
        make = {"rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                                activation="relu", prefix=pre),
                "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                                activation="tanh", prefix=pre),
                "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre),
                "gru": lambda pre: GRUCell(self._num_hidden, prefix=pre),
                }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, i)),
                    make("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(_ContainerCellMixin, BaseRNNCell):
    """Stack cells; each cell's output feeds the next."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        """Append a cell to the stack, merging its parameter dict."""
        self._cells.append(cell)
        self._absorb_cell_params(cell)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            inputs, state = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            first, _ = _normalize_sequence(length, inputs, layout, False)
            begin_state = self._default_begin_state(first[0])
        pos = 0
        next_states = []
        last = len(self._cells) - 1
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=begin_state[pos:pos + n],
                layout=layout,
                merge_outputs=None if i < last else merge_outputs)
            pos += n
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless cell applying dropout to its input."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        if not isinstance(dropout, numeric_types):
            raise TypeError("dropout probability must be a number, got %r"
                            % (dropout,))
        self.dropout = dropout

    @property
    def state_info(self):
        return []  # carries no recurrent state

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


@contextmanager
def _unlocked(cell):
    """Temporarily lift a wrapped cell's do-not-call-directly latch so its
    owner (a ModifierCell) can delegate into it."""
    cell._modified = False
    try:
        yield cell
    finally:
        cell._modified = True


class ModifierCell(BaseRNNCell):
    """Wrap a base cell and modify its behavior (dropout-like wrappers).

    Wrapping latches the base cell (``_modified``) so users can't step it
    directly anymore; the wrapper delegates through :func:`_unlocked`."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True  # latch: step through the wrapper only
        self.base_cell = base_cell

    @property
    def params(self):
        """The wrapped cell's parameters (a modifier owns none itself)."""
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        self._assert_not_modified()
        with _unlocked(self.base_cell) as cell:
            return cell.begin_state(func, **kwargs)

    def _default_begin_state(self, first_input, time_major_ref=False):
        with _unlocked(self.base_cell) as cell:
            return cell._default_begin_state(first_input, time_major_ref)

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout: randomly keep previous outputs/states (Krueger et al.)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        p_out, p_state = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = (symbol.where(mask(p_out, next_output), next_output,
                               prev_output)
                  if p_out != 0. else next_output)
        states = ([symbol.where(mask(p_state, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_state != 0. else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Add the cell's input to its output (Wu et al. 2016)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return symbol.elemwise_add(output, inputs), states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        with _unlocked(self.base_cell) as cell:
            outputs, states = cell.unroll(
                length, inputs=inputs, begin_state=begin_state, layout=layout,
                merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = isinstance(outputs, symbol.Symbol)
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(out, inp)
                       for out, inp in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(_ContainerCellMixin, BaseRNNCell):
    """Run one cell forward and one backward over the sequence, concat."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        self._cells = [l_cell, r_cell]
        for cell in self._cells:
            self._absorb_cell_params(cell)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._default_begin_state(inputs[0])
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=merge_outputs)

        if merge_outputs is None:
            merge_outputs = (isinstance(l_outputs, symbol.Symbol)
                             and isinstance(r_outputs, symbol.Symbol))
            if not merge_outputs:
                if isinstance(l_outputs, symbol.Symbol):
                    l_outputs = list(symbol.SliceChannel(
                        l_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
                if isinstance(r_outputs, symbol.Symbol):
                    r_outputs = list(symbol.SliceChannel(
                        r_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))

        if merge_outputs:
            l_outputs = [l_outputs]
            r_outputs = [symbol.reverse(r_outputs, axis=axis)]
        else:
            r_outputs = list(reversed(r_outputs))

        outputs = [symbol.Concat(l_o, r_o, dim=1 + merge_outputs,
                                 name=("%sout" % self._output_prefix
                                       if merge_outputs
                                       else "%st%d" % (self._output_prefix, i)))
                   for i, (l_o, r_o) in enumerate(zip(l_outputs, r_outputs))]
        if merge_outputs:
            outputs = outputs[0]
        return outputs, [l_states, r_states]
