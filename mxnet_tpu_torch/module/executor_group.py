"""DataParallelExecutorGroup (counterpart of
``mxnet_tpu/module/executor_group.py``): the executors of a Module's
bind, and the batch's scatter to them and the outputs' gather.

The port binds one device: the group holds one executor, over arrays made
by shape inference.  Several contexts raise (``Module`` checks them); the
data-parallel route is ROADMAP queue 1 #8.  A batch is copied into the
executor's argument arrays in place (``executor.write_into``), so the
arrays a captured graph reads keep their storage.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..executor import Executor, write_into
from ..io.io import DataDesc
from ..ndarray import zeros as nd_zeros

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None):
        if len(contexts) != 1:
            raise MXNetError("binding over %d contexts is not ported yet "
                             "(ROADMAP queue 1 #8); bind one device"
                             % len(contexts))
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        data_names = [d[0] for d in data_shapes]
        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = ("null" if name in self.fixed_param_names
                                       else grad_req) if for_training \
                    else "null"
            elif name in data_names:
                self.grad_req[name] = grad_req if inputs_need_grad else "null"
            else:
                self.grad_req[name] = "null"
        self.execs = []
        self.batch_size = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        axis = DataDesc.get_batch_axis(getattr(data_shapes[0], "layout",
                                               "NCHW"))
        self.batch_size = data_shapes[0].shape[axis]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        shapes = {d.name: d.shape for d in data_shapes}
        for d in label_shapes or []:
            shapes[d.name] = d.shape
        arg_shapes, _, aux_shapes = self.symbol._infer_shape_impl(False,
                                                                  **shapes)
        if arg_shapes is None or any(s is None for s in arg_shapes):
            raise MXNetError("shape inference failed in bind")
        ctx = self.contexts[0]
        old = self.execs[0] if reshape and self.execs else None
        args, args_grad = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            keep = old is not None and name in self.param_names
            args[name] = old.arg_dict[name] if keep \
                else nd_zeros(shape, ctx=ctx)
            if self.grad_req.get(name, "null") != "null":
                args_grad[name] = nd_zeros(shape, ctx=ctx)
        aux = {name: old.aux_dict[name] if old is not None
               else nd_zeros(shape, ctx=ctx)
               for name, shape in zip(self.aux_names, aux_shapes)}
        self.execs = [Executor(self.symbol, ctx, args, args_grad,
                               self.grad_req, aux)]
        self._collect_arrays()

    def _collect_arrays(self):
        e = self.execs[0]
        self.data_arrays = [e.arg_dict[d.name] for d in self.data_shapes]
        self.label_arrays = [e.arg_dict[d.name]
                             for d in self.label_shapes or []]
        self.param_arrays = [[e.arg_dict[name]] for name in self.param_names
                             if name in self.arg_names]
        self.grad_arrays = [[e.grad_dict.get(name)]
                            for name in self.param_names] \
            if self.for_training else []
        self.input_grad_arrays = [[e.grad_dict.get(d.name)]
                                  for d in self.data_shapes] \
            if self.inputs_need_grad else []
        self.aux_arrays = [[e.aux_dict[name]] for name in self.aux_names]

    def single_executor(self):
        """The one executor, which the compiled step captures."""
        return self.execs[0]

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        for name, block in zip(self.param_names, self.param_arrays):
            write_into(arg_params[name], block[0])
        for name, block in zip(self.aux_names, self.aux_arrays):
            write_into(aux_params[name], block[0])

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        e = self.execs[0]
        for desc, src in zip(self.data_shapes, data_batch.data):
            write_into(e.arg_dict[desc.name], src)
        if self.label_shapes is not None and data_batch.label:
            for desc, src in zip(self.label_shapes, data_batch.label):
                write_into(e.arg_dict[desc.name], src)
        e.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        e = self.execs[0]
        e.backward(out_grads)
        # the executor may have made the gradient arrays in this backward
        self.grad_arrays = [[e.grad_dict.get(name)]
                            for name in self.param_names]

    def get_outputs(self, merge_multi_context=True):
        outputs = self.execs[0].outputs
        return list(outputs) if merge_multi_context \
            else [[o] for o in outputs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [self.execs[0].grad_dict.get(d.name)
                 for d in self.data_shapes]
        return grads if merge_multi_context else [[g] for g in grads]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.execs[0].outputs)
