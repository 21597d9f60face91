"""Checkpoints of the legacy RNN API (counterpart of
``mxnet_tpu/rnn/rnn.py``): the cells' weights are saved unpacked and packed
again on load, so a checkpoint does not depend on the cells' layout.  The
files are ``model.save_checkpoint``'s, which both packages read.
"""
from __future__ import annotations

import warnings

from ..model import save_checkpoint, load_checkpoint

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def _as_cell_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC"):
    """Deprecated: use cell.unroll instead."""
    warnings.warn("rnn_unroll is deprecated. Please call cell.unroll directly.")
    return cell.unroll(length=length, inputs=inputs, begin_state=begin_state,
                       layout=layout)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save a checkpoint with every cell's weights unpacked."""
    for cell in _as_cell_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint (onto the current context), packing the weights
    again for the given cells."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cell_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that calls save_rnn_checkpoint every
    ``period`` epochs."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
