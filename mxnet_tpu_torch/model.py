"""Checkpoints and the updater loop of the Module API (counterpart of
``mxnet_tpu/model.py``: ``BatchEndParam``, ``_create_kvstore`` :27-49,
``_update_params`` :83, ``save_checkpoint``/``load_checkpoint``
:98-146).

Only what ``Module`` needs on one device.  No kvstore exists on one device
(``_create_kvstore`` gives ``None``, as the JAX package's does there); a
``dist`` store, or a ``KVStore`` object, raises until ROADMAP queue 1 #13
ports ``kvstore.py``.  A checkpoint is ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:``/``aux:`` keys, in the bytes both
packages read (``nd.save``).  The checkpoint manifest and the resume
functions (:147-300) are not ported yet.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): ``(None, False)`` for one device and
    no ``dist`` store, which is all the port has."""
    if kvstore is None:
        return (None, False)
    if isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            return (None, False)
    raise MXNetError(
        "kvstore %r needs a KVStore, which is not ported yet (ROADMAP "
        "queue 1 #13); train on one device with kvstore='local' or None"
        % (kvstore,))


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local updater over each device copy (``model.py:83``); the
    updater takes the arrays' tensors and updates them in place."""
    if kvstore:
        raise MXNetError("kvstore updates are not ported yet (ROADMAP queue "
                         "1 #13)")
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(i * num_device + k, g._data, w._data)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``."""
    from .ndarray import utils
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    utils.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint; the arrays load
    onto ``ctx`` (default the current context)."""
    from . import symbol as sym
    from .ndarray import utils
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = utils.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)
