"""Modules written in Python, with no Symbol or executor underneath
(counterpart of ``mxnet_tpu/module/python_module.py``): ``PythonModule``,
whose computation is the subclass's own code over NDArrays and which holds
no parameters by default, and ``PythonLossModule``, a loss head whose
backward gives a hand-written input gradient (``grad_func``, or softmax
cross-entropy's ``softmax(scores) - one_hot(labels)``).  They run eagerly
through ``mx.nd``; a pipeline that puts a Python stage between symbolic
modules (under SequentialModule) ports unchanged."""
from __future__ import annotations

import logging

from .base_module import BaseModule
from ..io.io import DataDesc
from ..base import MXNetError


class PythonModule(BaseModule):
    """A module whose forward is plain Python over NDArrays.

    Subclasses override ``forward`` (and ``backward`` when trainable).
    Parameter-less by default: ``get_params`` returns empty dicts and
    ``update`` is a no-op; override both to hold state.
    """

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- information ----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none by default) -----------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    # -- binding ---------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write", "PythonModule only supports write grad_req"
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = ([d if isinstance(d, DataDesc) else DataDesc(*d)
                               for d in label_shapes]
                              if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        """Deduce output shapes from the bound input shapes; subclasses
        must implement (there is no graph to infer from)."""
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        pass

    def get_input_grads(self, merge_multi_context=True):
        raise MXNetError("PythonModule subclass must implement "
                         "get_input_grads when inputs_need_grad")

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A pass-through loss head: forward keeps its input, backward emits a
    caller-supplied input gradient (``grad_func``) or the canonical
    softmax-CE convenience gradient when none is given.
    """

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names=data_names, label_names=label_names,
                         output_names=["%s_output" % name], logger=logger)
        self._name = name
        assert len(self._data_names) == 1
        assert len(self._label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        # the loss output mirrors the score input
        return [(self._output_names[0], self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "loss module sits at the head"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
        else:
            # d/dscores of softmax cross-entropy with integer labels
            from .. import ndarray as nd
            prob = nd.softmax(self._scores)
            one_hot = nd.one_hot(self._labels.astype("int32"),
                                 int(prob.shape[-1]))
            grad = prob - one_hot
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]
