"""Module: symbolic training (counterpart of
``mxnet_tpu/module/module.py``), on one device.

``bind`` makes the executor group, ``init_params``/``init_optimizer``
set the arrays and the local updater, ``forward``/``backward``/``update``
run a step, ``save_checkpoint``/``load`` write and read
``prefix-symbol.json`` and ``prefix-%04d.params``, which both packages
read.  ``context`` defaults to the current context (``cuda:0``); pass
``mx.cpu()`` to train on the CPU.  Several contexts, a real kvstore,
``group2ctxs`` and ``state_names`` are not ported yet and raise.
"""
from __future__ import annotations

import logging
import warnings

import torch

from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup
from .. import optimizer as opt
from ..base import MXNetError
from ..context import current_context, resolve_device
from ..initializer import Uniform, InitDesc
from ..model import _create_kvstore, _update_params, load_checkpoint
from ..io.io import DataDesc
from ..ndarray import zeros


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        ctxs = context if context is not None else current_context()
        self._context = [resolve_device(c) for c in
                         (ctxs if isinstance(ctxs, (list, tuple))
                          else [ctxs])]
        if len(self._context) != 1:
            raise MXNetError("Module over %d contexts is not ported yet "
                             "(ROADMAP queue 1 #8); pass one context"
                             % len(self._context))
        if group2ctxs or state_names:
            raise MXNetError("group2ctxs and state_names are not ported yet")
        self._work_load_list = (list(work_load_list) if work_load_list
                                else [1] * len(self._context))
        if len(self._work_load_list) != len(self._context):
            raise AssertionError("work_load_list must have one entry per context")

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + (state_names or [])
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()

        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param", True)

        # parameter state, optimizer state, and bind state all start empty
        for attr in ("_arg_params", "_aux_params", "_optimizer", "_kvstore",
                     "_update_on_kvstore", "_updater", "_preload_opt_states",
                     "_grad_req", "_exec_group", "_data_shapes", "_label_shapes"):
            setattr(self, attr, None)
        self._params_dirty = False
        self._compression_params = compression_params
        self._group2ctxs = group2ctxs

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        ctx = kwargs.get("context")
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (and,
        with ``save_optimizer_states``, ``prefix-%04d.states``), each
        atomically, then commit them together as one entry of
        ``prefix-manifest.json`` (``model.record_checkpoint``): a crash
        anywhere leaves the previous complete checkpoint restorable."""
        from ..model import record_checkpoint
        symbol_file = "%s-symbol.json" % prefix
        self._symbol.save(symbol_file)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        files = [symbol_file, param_name]
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            files.append(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)
        record_checkpoint(prefix, epoch, files)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = self._data_shapes = self._label_shapes = None

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
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outputs = self._exec_group.execs[0].forward(is_train=False) \
            if not self._exec_group.execs[0].outputs else self._exec_group.execs[0].outputs
        return list(zip(self._output_names, [o.shape for o in outputs]))

    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "init_params call ignored.", stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)

        ctx = self._context[0]
        if self._arg_params is None:
            param_arrays = [zeros(x[0].shape, ctx=ctx, dtype=x[0].dtype)
                            for x in self._exec_group.param_arrays]
            self._arg_params = {name: arr for name, arr in
                                zip(self._param_names, param_arrays)}
        if self._aux_params is None:
            aux_arrays = [zeros(x[0].shape, ctx=ctx, dtype=x[0].dtype)
                          for x in self._exec_group.aux_arrays]
            self._aux_params = {name: arr for name, arr in
                                zip(self._aux_names, aux_arrays)}

        def _fill(desc, arr, provided):
            # prefer a user-provided value; otherwise fall back to the
            # initializer (or fail, when missing values are not allowed)
            src = provided.get(desc) if provided is not None else None
            if src is not None:
                if src is not arr:
                    from ..executor import write_into
                    write_into(arr, src)
                return
            if provided is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % desc)
            if initializer is not None:
                initializer(desc, arr)

        attrs = self._symbol.attr_dict()
        for params, provided in ((self._arg_params, arg_params),
                                 (self._aux_params, aux_params)):
            for name, arr in sorted(params.items()):
                _fill(InitDesc(name, attrs.get(name, None)), arr, provided)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params, allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        if not for_training:
            assert not inputs_need_grad

        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)

        shared_group = None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names, group2ctxs=self._group2ctxs)
        self.binded = True

        if self.params_initialized:
            # params were set before binding (e.g. Module.load)
            self._exec_group.set_params(self._arg_params, self._aux_params)

        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group.bind_exec(self._data_shapes, self._label_shapes,
                                   reshape=True)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        idx2name = dict(enumerate(self._exec_group.param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn("Optimizer created manually outside Module but "
                              "rescale_grad is not normalized to "
                              "1.0/batch_size (%s vs. %s)."
                              % (optimizer.rescale_grad, rescale_grad))
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name
                optimizer.set_wd_mult(optimizer.wd_mult)
        self._optimizer, self._kvstore = optimizer, kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, updater and kvstore (a
        BucketingModule's buckets share one optimizer state)."""
        assert shared_module.optimizer_initialized
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        curr_data_shapes = tuple(i.shape for i in self._data_shapes)
        if isinstance(data_batch, list):
            assert data_batch is not None, "Encountered empty data batch"
            new_data_shapes = tuple(i.shape for i in data_batch[0].data)
        else:
            new_data_shapes = tuple(i.shape for i in data_batch.data)
        if curr_data_shapes != new_data_shapes:
            if hasattr(data_batch, "provide_data") and data_batch.provide_data:
                new_dshape = data_batch.provide_data
            else:
                new_dshape = [DataDesc(i.name, shape, i.dtype, i.layout)
                              for i, shape in zip(self._data_shapes, new_data_shapes)]
            if hasattr(data_batch, "provide_label") and data_batch.provide_label:
                new_lshape = data_batch.provide_label
            elif hasattr(data_batch, "label") and data_batch.label:
                new_lshape = [DataDesc(i.name, j.shape, i.dtype, i.layout)
                              for i, j in zip(self._label_shapes, data_batch.label)]
            else:
                new_lshape = None
            self.reshape(new_dshape, new_lshape)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        group = self._exec_group
        _update_params(group.param_arrays, group.grad_arrays,
                       updater=self._updater, num_device=1,
                       kvstore=self._kvstore, param_names=group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context=merge_multi_context)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """Write the updater's states, atomically, in the file both
        packages read (``optimizer.Updater.get_states``)."""
        assert self.optimizer_initialized
        from ..util import write_atomic
        write_atomic(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Read a states file that either package wrote.  Under a compiled
        train step the loaded values are copied into the state tensors its
        graph updates in place."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        if getattr(self, "_compiled_step", None) is not None:
            self._compiled_step.reload_optimizer_states()

    def _compiled_step_handles(self):
        """Everything CompiledTrainStep.from_module needs to capture this
        module's whole training iteration as one CachedOp, or raise
        CompiledStepUnsupported with the reason the eager loop must run
        (module/compiled_step.py owns the traceability checks on top)."""
        from .compiled_step import CompiledStepUnsupported
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            raise CompiledStepUnsupported(
                "module must be bound/initialized with an optimizer")
        if len(self._context) != 1:
            raise CompiledStepUnsupported(
                "multi-context bind (%d devices); the compiled step needs a "
                "single-device executor" % len(self._context))
        if self._kvstore is not None or self._update_on_kvstore:
            raise CompiledStepUnsupported(
                "kvstore-backed update; the compiled step needs the local "
                "updater path")
        if self.inputs_need_grad:
            raise CompiledStepUnsupported(
                "inputs_need_grad: input gradients are not materialized by "
                "the fused step")
        return {
            "executor": self._exec_group.single_executor(),
            "optimizer": self._optimizer,
            "updater": self._updater,
            "param_names": list(self._param_names),
            # bound-shape order, NOT self._data_names order: batch.data
            # arrives in the iterator's provide_data order, and the eager
            # scatter (executor_group.forward) matches positionally against
            # data_shapes — the compiled step must bind the same way or a
            # provide order differing from data_names order would silently
            # swap same-shaped inputs
            "data_names": [d.name for d in self._data_shapes],
            "label_names": [l.name for l in (self._label_shapes or [])],
            "context": self._context[0],
        }



def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                   for x in data_shapes]
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                        for x in label_shapes]
        _check_names_match(label_names, label_shapes, "label", False)
    else:
        _check_names_match(label_names, [], "label", False)
    return data_shapes, label_shapes


def _check_names_match(data_names, data_shapes, name, throw):
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = "Data provided by %s_shapes don't match names specified by " \
              "%s_names (%s vs. %s)" % (name, name, str(data_shapes), str(data_names))
        if throw:
            raise ValueError(msg)
        warnings.warn(msg)
