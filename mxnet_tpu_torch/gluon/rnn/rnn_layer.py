"""Gluon's fused recurrent layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and ``GRU`` over
the ``RNN`` op.

Each layer and direction keeps its own ``{l,r}{k}_{i2h,h2h}_{weight,bias}``
parameters, packed into the op's blob on every call
(``_collect_flat_parameters``); the input size waits for the first call.
``layout`` is ``"TNC"`` or ``"NTC"``.  ``layer(x)`` returns the output
alone, with zero begin states; ``layer(x, states)`` (a list, or one array)
returns ``(output, new_states)``.  Called with Symbols the layer traces
``hybrid_forward``, which needs the states as Symbols after ``x``
(``layer(x, h, c)``) and raises ``ValueError`` without them, as the JAX
layer does.  Hybridized, a call goes through the layer's CachedOp (one
CUDA graph of the whole time loop a signature on the card), with or
without explicit states: the states enter it as inputs of their own.  The
JAX package's CachedOp takes no list, so its hybridized layer called with
explicit states raises; the port's runs.
"""
from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd
from ...context import resolve_device
from ...ndarray.ndarray import NDArray
from ...ndarray.register import tensor_ops
from ...symbol.symbol import Symbol

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._device = resolve_device(device)
        self._mode = mode
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        self._hidden_size, self._num_layers = hidden_size, num_layers
        self._layout, self._dropout = layout, dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param("{}{}_i2h_weight".format(j, i),
                                         (ng * nh, ni),
                                         i2h_weight_initializer)
                    self._register_param("{}{}_h2h_weight".format(j, i),
                                         (ng * nh, nh),
                                         h2h_weight_initializer)
                    self._register_param("{}{}_i2h_bias".format(j, i),
                                         (ng * nh,), i2h_bias_initializer)
                    self._register_param("{}{}_h2h_bias".format(j, i),
                                         (ng * nh,), h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def _shape_hook(self, x, *args):
        self._input_size = x.shape[2]
        ni = x.shape[2]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                self._reg_params["{}{}_i2h_weight".format(j, i)].shape = (
                    self._gates * self._hidden_size, ni)
            ni = self._hidden_size * self._dir

    def extra_repr(self):
        shape = self._reg_params["l0_i2h_weight"].shape
        s = "{0} -> {1}, {2}".format(shape[1] if shape[1] else None,
                                     shape[0] // self._gates, self._layout)
        if self._num_layers != 1:
            s += ", num_layers=%d" % self._num_layers
        if self._dropout != 0:
            s += ", dropout=%s" % self._dropout
        if self._dir == 2:
            s += ", bidirectional"
        return s

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """One ``func(shape, **kwargs)`` a state (default ``nd.zeros`` on
        the current context, or ``ctx=``)."""
        states = []
        for info in self.state_info(batch_size):
            extra = {k: v for k, v in kwargs.items()
                     if k not in ("shape", "__layout__")}
            states.append(func(info["shape"], **extra))
        return states

    def _collect_flat_parameters(self, F, params):
        """The per-layer weights packed in the fused blob's order: every
        weight, layer by layer and direction by direction, then every
        bias."""
        ws = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                ws.append(params["{}{}_i2h_weight".format(j, i)].reshape(
                    (-1,)))
                ws.append(params["{}{}_h2h_weight".format(j, i)].reshape(
                    (-1,)))
        bs = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                bs.append(params["{}{}_i2h_bias".format(j, i)].reshape((-1,)))
                bs.append(params["{}{}_h2h_bias".format(j, i)].reshape((-1,)))
        return F.concat(*(ws + bs), dim=0)

    def __call__(self, x, *states):
        if isinstance(x, Symbol):
            return self._build_symbol(x, *states)
        if len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = tuple(states[0])
        as_nd = isinstance(x, NDArray)
        flat = [s._data if isinstance(s, NDArray) else s for s in states]
        x = x._data if as_nd else x
        # through the CachedOp when active (after an eager first call that
        # settles deferred shapes, as in the JAX package): the states as
        # inputs of their own, the new ones as outputs after the sequence's
        out = HybridBlock.__call__(self, x, *flat)
        wrap = NDArray if as_nd else (lambda t: t)
        if not flat:
            return wrap(out)
        return wrap(out[0]), [wrap(s) for s in out[1:]]

    def forward(self, x, *states):
        """``x`` and the begin states as tensors; the output alone when no
        state is given, else ``(output, *new_states)``."""
        params = {k: getattr(self, k) for k in self._reg_params}
        batch_size = x.shape[self._layout.find("N")]
        skip_states = not states
        if skip_states:
            states = [s._data for s in self.begin_state(
                batch_size, ctx=x.device, dtype=x.dtype)]
        for state, info in zip(states, self.state_info(batch_size)):
            if tuple(state.shape) != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(tuple(state.shape))))
        out, new_states = self._forward_kernel(tensor_ops, x, list(states),
                                               params)
        return out if skip_states else (out, *new_states)

    def hybrid_forward(self, F, x, *args, **params):
        states = list(args) if args else None
        if states is None:
            raise ValueError("hybridized RNN layers require explicit begin "
                             "states in this build")
        return self._forward_kernel(F, x, states, params)

    def _forward_kernel(self, F, x, states, params):
        if self._layout == "NTC":
            x = F.transpose(x, axes=(1, 0, 2))
        flat = self._collect_flat_parameters(F, params)
        outs = F.RNN(x, flat, *states, state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = outs[0], [outs[1], outs[2]]
        else:
            outputs, states = outs[0], [outs[1]]
        if self._layout == "NTC":
            outputs = F.transpose(outputs, axes=(1, 0, 2))
        return outputs, states


class RNN(_RNNLayer):
    """A multi-layer Elman RNN with ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, prefix,
                         params, device)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """A multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", prefix, params,
                         device)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """A multi-layer GRU (cuDNN's formula)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", prefix, params, device)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
