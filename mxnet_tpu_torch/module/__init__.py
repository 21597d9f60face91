"""``mx.mod`` (counterpart of ``mxnet_tpu/module``): ``Module`` on one
device, its executor group, and the compiled train step.
``BucketingModule``, ``SequentialModule`` and ``PythonModule`` are not
ported yet."""
from .base_module import BaseModule
from .compiled_step import CompiledStepUnsupported, CompiledTrainStep
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup",
           "CompiledTrainStep", "CompiledStepUnsupported"]
