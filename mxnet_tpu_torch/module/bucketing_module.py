"""BucketingModule (port of `mxnet_tpu/module/bucketing_module.py`;
upstream `python/mxnet/module/bucketing_module.py`): one Module a bucket
key, each bound to the graph `sym_gen(key)` returns, all sharing one set
of parameter values and one optimizer.

Sharing is by copy, as in the reference: a switch to another bucket
copies the current bucket's parameters into the new one (`get_params` then
`init_params(force_init=True)`), tensor to tensor on the module's device,
so nothing crosses to the host. Every bucket advances the one optimizer
the first bucket created (`Module.borrow_optimizer`), so Adam's moments
do not restart when batches alternate between buckets. A monitor
installed on the module is installed on buckets bound later too, as
upstream's is. Not ported yet: the mesh arguments (slice 5).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._opt_config = None
        self._opt_owner = None  # the Module whose optimizer all buckets share
        self._monitor = None

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names,
                      compression_params=self._compression_params)

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module at these shapes."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, grad_req=grad_req)
        if self._monitor is not None:
            module.install_monitor(self._monitor)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make `bucket_key`'s module the current one, binding it first (at
        these shapes, from the default bucket's parameters) if new."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, force_rebind=False)
            default_mod = self._buckets[self._default_bucket_key]
            if default_mod.params_initialized:
                arg, aux = default_mod.get_params()
                module.init_params(arg_params=arg, aux_params=aux,
                                   allow_missing=False, force_init=True)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
        if self._opt_config is not None and \
                not self._curr_module.optimizer_initialized:
            assert self._opt_owner is not None  # set with _opt_config
            self._curr_module.borrow_optimizer(self._opt_owner)

    def forward(self, data_batch, is_train=None):
        """Forward on the batch's bucket, switching to it (and copying the
        current parameters into it) when it is another."""
        assert self.binded and self.params_initialized
        if data_batch.bucket_key is not None and \
                data_batch.bucket_key != self._curr_bucket_key:
            arg, aux = self._curr_module.get_params() \
                if self._curr_module.params_initialized else (None, None)
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
            if arg is not None:
                self._curr_module.init_params(arg_params=arg, aux_params=aux,
                                              force_init=True)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The current bucket's optimizer, borrowed by every other bucket
        bound now or later."""
        assert self.binded and self.params_initialized
        self._opt_config = dict(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params,
                                force_init=force_init)
        self._curr_module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                         optimizer_params=optimizer_params,
                                         force_init=force_init)
        self._opt_owner = self._curr_module
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._opt_owner)
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def get_states(self, merge_multi_context=True):
        assert self._curr_module is not None, "bind and forward first"
        return self._curr_module.get_states(
            merge_multi_context=merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self._curr_module is not None, "bind and forward first"
        self._curr_module.set_states(states=states, value=value)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Bind the batch's bucket if new, then make the current bucket
        current again (the reference's order: `forward` switches)."""
        original = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        if original is not None and original != data_batch.bucket_key:
            self.switch_bucket(original, None, None)
