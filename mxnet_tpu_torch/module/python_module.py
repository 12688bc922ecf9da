"""PythonModule and PythonLossModule (port of
`mxnet_tpu/module/python_module.py`; upstream
`python/mxnet/module/python_module.py`): a module whose computation is
Python code, without parameters, for instance a loss written by hand at
the end of a SequentialModule.

`PythonLossModule` passes its data through as its output and, in
backward, hands its predecessor the gradient `grad_func(scores, labels)`
returns (an NDArray, or an array made one on the scores' context).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from ..ndarray import NDArray


def _desc(d):
    return d if isinstance(d, tuple) else (d.name, d.shape)


class PythonModule(BaseModule):
    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) \
            if label_names is not None else None
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

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

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [_desc(d) for d in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [_desc(d) for d in label_shapes]
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        """[(name, shape)] of the outputs at the bound data shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss module: out_grads must be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        """The scores' gradient from `grad_func` (a subclass without one
        overrides this)."""
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            grad = NDArray(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
