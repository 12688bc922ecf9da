"""The Module training API (port of `mxnet_tpu/module/`): BaseModule,
Module, BucketingModule, SequentialModule, PythonModule and
PythonLossModule."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
