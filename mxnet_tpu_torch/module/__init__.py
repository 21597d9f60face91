"""``mx.mod`` (counterpart of ``mxnet_tpu/module``): ``Module`` on one
device, its executor group and the compiled train step;
``BucketingModule``, ``SequentialModule``, ``PythonModule`` and
``PythonLossModule``."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .compiled_step import CompiledStepUnsupported, CompiledTrainStep
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "DataParallelExecutorGroup",
           "CompiledTrainStep", "CompiledStepUnsupported"]
