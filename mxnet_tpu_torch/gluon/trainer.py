"""Gluon Trainer (port of `mxnet_tpu/gluon/trainer.py`).

`step` = allreduce + the optimizer's update through an `Updater`, as the
reference's. Each parameter has one buffer on one device, so with a
kvstore of "device", "local" or None, or any store of one worker, there
is nothing to reduce: the reference's own single-worker behaviour
(`trainer.py:106-114`). With a KVStore object or a distributed type
('dist_sync', 'nccl', ...) whose store has several workers (a
torch.distributed world, `kvstore.py`), each gradient is averaged over
the workers before the update (the reference's `trainer.py:108`), every
gradient of one dtype in one allreduce. `compression_params` set the
store's 2-bit compression, as the reference's: it applies to what is
pushed to the store, and the averaged gradients are the raw ones.
"""
from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.lr if self._optimizer.lr_scheduler is None \
            else self._optimizer.lr_scheduler(self._optimizer.num_update)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        """The store named by `kvstore` (a KVStore object is used as it
        is), with the compression asked for."""
        if isinstance(self._kv_type, kvs.KVStore):
            self._kvstore = self._kv_type
        elif self._kv_type is None:
            self._kvstore = None
        else:
            self._kvstore = kvs.create(self._kv_type)
        if self._kvstore is not None and self._compression_params:
            self._kvstore.set_gradient_compression(self._compression_params)
        self._kv_initialized = True

    def _row_sparse_pull(self, parameter, out, row_id):
        """The rows `row_id` of `parameter` from the store into `out`
        (its key initialized from the parameter's value first); nothing
        without a store."""
        if not self._kv_initialized:
            self._init_kvstore()
        idx = self._params.index(parameter)
        if self._kvstore is not None:
            key = "param_%d" % idx
            if key not in self._kvstore._store:
                self._kvstore.init(key, parameter.data())
            self._kvstore.row_sparse_pull(key, out=out, row_ids=row_id)

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce + update, the gradients rescaled by 1 / batch_size."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """The gradients averaged over the store's workers (nothing to do
        with one worker)."""
        kv = self._kvstore
        if kv is None or kv.num_workers <= 1:
            return
        grads = [p._grad for p in self._params
                 if p.grad_req != "null" and p._grad is not None]
        for g, total in zip(grads, kvs._multihost_psum(
                [g._data for g in grads])):
            g._data.copy_(total / kv.num_workers)

    def _update(self, ignore_stale_grad=False):
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            grad = param._grad
            if grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    "Gradient of Parameter `%s` not found. Call backward "
                    "first." % param.name)
            updater(i, grad, param.data())

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone (after allreduce_grads)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def save_states(self, fname):
        """Write the optimizer states (host copies) to fname."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Read states written by `save_states` (a pickle: load only files
        this program wrote)."""
        with open(fname, "rb") as f:
            states = f.read()
        self._updaters[0].set_states(states)
        self._updaters[0].optimizer = self._optimizer
