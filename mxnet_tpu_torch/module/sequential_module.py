"""SequentialModule (port of `mxnet_tpu/module/sequential_module.py`;
upstream `python/mxnet/module/sequential_module.py`): modules in a chain,
each one's outputs the next one's data, the gradients back along it.

`add(module, take_labels=True)` gives that module the batch's labels (and
makes it the one whose outputs the metric reads); `auto_wiring=True`
renames the incoming outputs to the module's own data names at bind. A
module after the first is bound with input gradients, which its
predecessor's backward takes as head gradients.

One deliberate difference from the reference: `bind` does not initialize
the chained modules' parameters (upstream's order), so the initializer
given to `init_params` or `fit` is the one that sets them; the
reference's `bind` sets them from `Uniform(0.01)` first, and its
`init_params` then leaves them.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from ..io import DataBatch


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._meta_keys = {SequentialModule.META_TAKE_LABELS,
                           SequentialModule.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append `module` (metas: take_labels, auto_wiring); returns self,
        so adds chain."""
        for key in kwargs:
            assert key in self._meta_keys, \
                "Unknown meta \"%s\", a typo?" % key
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params, allow_missing=True,
                               force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each module at its predecessor's output shapes."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert self._modules, "add a module before binding"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        for i_layer, (meta, module) in enumerate(zip(self._metas,
                                                     self._modules)):
            my_label_shapes = label_shapes if meta.get(
                SequentialModule.META_TAKE_LABELS, False) else None
            my_inputs_need_grad = inputs_need_grad if i_layer == 0 else True
            if meta.get(SequentialModule.META_AUTO_WIRING, False):
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [
                    (new_name, d.shape if hasattr(d, "shape") else d[1])
                    for new_name, d in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            my_data_shapes = list(module.output_shapes or [])
        self.binded = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = DataBatch(data=data_batch.data, label=data_batch.label,
                          pad=data_batch.pad)
        for i_layer, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            label = batch.label if self._metas[i_layer + 1].get(
                SequentialModule.META_TAKE_LABELS, False) else None
            batch = DataBatch(data=module.get_outputs(), label=label,
                              pad=batch.pad)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i_layer, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for meta, module in zip(self._metas, self._modules):
            if meta.get(SequentialModule.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
