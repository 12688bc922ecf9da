"""Module: a symbol bound to one executor (port of
`mxnet_tpu/module/module.py`).

One executor runs the whole batch on the module's context (the current
context, `gpu(0)` unless the caller enters `with mx.cpu():` or passes
`context=`). The updater's integer keys and the kvstore's keys follow
`_param_names`, the symbol's `list_arguments()` order less the data,
label and state names, as the reference's do. Not ported yet: the mesh
branches (slice 5, distributed training).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from ..base import MXNetError
from ..context import current_context
from ..executor import Executor
from .. import optimizer as opt
from .. import kvstore as kvs


def _assign(arr, src):
    """arr's data := src's values in arr's shape, dtype and device."""
    arr._data = src._data.detach().reshape(arr.shape).to(
        device=arr._data.device, dtype=arr._data.dtype).clone()


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError(
                    "Module over %d contexts is not ported yet: data "
                    "parallelism comes with slice 5 of the port "
                    "(distributed training)" % len(context))
            context = context[0]
        self._context = context
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + list(state_names or [])
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._static_output_shapes = None
        self._preload_opt_states = None
        self.inputs_need_grad = False

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint's symbol and parameters (which bind
        sets into the executor); with load_optimizer_states, init_optimizer
        reads `<prefix>-%04d.states`."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties ---------------------------------------------------------
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
        if self._exec.outputs:
            return [(n, o.shape) for n, o in
                    zip(self._output_names, self._exec.outputs)]
        if self._static_output_shapes is None:
            try:
                shapes = dict(self._data_shapes + (self._label_shapes or []))
                _, out_shapes, _ = self._symbol.infer_shape(**shapes)
            except MXNetError:
                return None
            self._static_output_shapes = list(zip(self._output_names,
                                                  out_shapes))
        return self._static_output_shapes

    # -- params -------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Each parameter from arg_params, else from the parameters a
        load or rebind kept, else from the initializer (Uniform(0.01) by
        default); aux states from aux_params or the kept ones."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        from ..initializer import InitDesc, Uniform
        initializer = initializer if initializer is not None \
            else Uniform(0.01)
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _assign(arr, arg_params[name])
            elif self._arg_params is not None and name in self._arg_params:
                _assign(arr, self._arg_params[name])
            elif initializer is not None:
                initializer(InitDesc(name), arr)
            elif not allow_missing:
                raise MXNetError("no initializer for %s" % name)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                _assign(arr, aux_params[name])
            elif self._aux_params is not None and name in self._aux_params:
                _assign(arr, self._aux_params[name])
        self.params_initialized = True
        self._params_dirty = False

    # -- bind ---------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """simple_bind the symbol at the given data and label shapes, the
        parameters' grad_req `grad_req` when for_training (fixed ones
        "null"); a rebind keeps the trained parameters."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if self.binded and self.params_initialized:
            # a rebind keeps the trained parameters of the executor it
            # drops, for the init_params below
            self._arg_params, self._aux_params = self.get_params()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._static_output_shapes = None
        shapes = {}

        def norm(descs):
            out = []
            for d in descs or []:
                name, shape = (d.name, d.shape) if hasattr(d, "name") else d
                shapes[name] = tuple(shape)
                out.append((name, tuple(shape)))
            return out

        self._data_shapes = norm(data_shapes)
        self._label_shapes = norm(label_shapes)
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._param_names and n not in self._fixed_param_names:
                req[n] = grad_req if for_training else "null"
            elif n in self._data_names and inputs_need_grad:
                req[n] = grad_req
            else:
                req[n] = "null"
        self._exec = Executor.simple_bind(self._symbol, self._context,
                                          grad_req=req, **shapes)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            arg, aux = shared_module.get_params()
            self._exec.copy_params_from(arg, aux)
            self.params_initialized = True
        elif self.params_initialized:
            # Module.load or a rebind: the kept parameters into the new
            # executor
            self.init_params(force_init=True)

    # -- compute ------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                if name in self._exec.arg_dict:
                    feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    # -- optimizer ----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (by name: rescale_grad 1/batch unless given, the
        parameters' names by index and the symbol's lr / wd multipliers),
        run inside the kvstore ("local" by default) or by an updater when
        kvstore is None."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if isinstance(optimizer, str):
            # the loss heads' gradients are not divided by the batch: the
            # optimizer rescales them
            batch_size = self._data_shapes[0][1][0] if self._data_shapes \
                else 1
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   sym=self._symbol, **optimizer_params)
        self._optimizer = optimizer
        if isinstance(kvstore, str):
            kvstore = kvs.create(kvstore) if kvstore else None
        self._kvstore = kvstore
        self._update_on_kvstore = kvstore is not None
        if kvstore is not None:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            kvstore.set_optimizer(self._optimizer)
            for i, name in enumerate(self._param_names):
                kvstore.init(i, self._exec.arg_dict[name])
        else:
            self._updater = opt.get_updater(self._optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share another module's optimizer and its state (updater or
        kvstore); the parameter orders must match, since the state is
        keyed by index."""
        assert shared_module.optimizer_initialized
        assert shared_module._param_names == self._param_names, \
            "borrow_optimizer requires identical parameter orderings"
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    def update(self):
        """One optimizer step from the gradients of the last backward:
        push and pull through the kvstore, or the updater."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        for i, name in enumerate(self._param_names):
            if self._exec._grad_req.get(name, "null") == "null":
                continue
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            weight = self._exec.arg_dict[name]
            if self._kvstore is not None:
                self._kvstore.push(i, grad)
                self._kvstore.pull(i, out=weight)
            else:
                self._updater(i, grad, weight)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def get_states(self, merge_multi_context=True):
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        for n, s in zip(self._state_names, states or []):
            _assign(self._exec.arg_dict[n], s)

    def install_monitor(self, mon):
        mon.install(self._exec)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Read states `save_optimizer_states` wrote (a pickle: load only
        files this program wrote)."""
        assert self.optimizer_initialized
        if self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def reshape(self, data_shapes, label_shapes=None):
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
