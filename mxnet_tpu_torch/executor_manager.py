"""The pre-Module multi-device executor manager (port of
`mxnet_tpu/executor_manager.py`; upstream
`python/mxnet/executor_manager.py`): `_split_input_slice`,
`DataParallelExecutorGroup` and `DataParallelExecutorManager`, the loop
under the FeedForward-era training scripts.

One executor a context over its slice of the batch. Parameters and
gradients are lists of per-executor arrays (`param_arrays[i][dev]`), as in
the reference, so the caller's update loop sums and writes them itself.
Two slices may share one device (`[gpu(0), gpu(0)]`): each keeps its own
arrays. A batch's slices are copied to each executor's device from the
iterator's host arrays.
"""
from __future__ import annotations

import logging

import torch

from .base import MXNetError
from .executor import Executor
from .ndarray import NDArray


def _split_input_slice(batch_size, work_load_list):
    """Batch slices in proportion to the work loads; raises when a slice
    would be empty."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        if end <= start:
            raise MXNetError(
                "too many slices: batch size %d cannot feed %d devices"
                % (batch_size, len(work_load_list)))
        slices.append(slice(start, end))
        start = end
    return slices


def _load_general(src, targets):
    """Copy each source array's slices into its (array, slice) targets,
    on each target's device and dtype."""
    for arr, targets_for_arr in zip(src, targets):
        t = arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)
        for dst, sl in targets_for_arr:
            dst._data = t[sl].detach().to(device=dst._data.device,
                                          dtype=dst._data.dtype)


def _desc(d):
    return (d.name, tuple(d.shape)) if hasattr(d, "name") \
        else (d[0], tuple(d[1]))


class DataParallelExecutorGroup:
    """One executor per context over a batch slice; with `shared_group`
    (another bucket's group) the parameters, gradients and aux states are
    that group's arrays."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None):
        self.param_names = list(param_names)
        self.arg_names = list(arg_names)
        self.aux_names = sym.list_auxiliary_states()
        data_shapes = dict(_desc(d) for d in
                           list(train_data.provide_data) +
                           list(train_data.provide_label))
        self.data_names = [_desc(d)[0] for d in train_data.provide_data]
        self.label_names = [_desc(d)[0] for d in train_data.provide_label]
        grad_req = {n: ("write" if n in set(param_names) else "null")
                    for n in arg_names}
        self.train_execs = []
        for i, c in enumerate(ctx):
            rows = slices[i].stop - slices[i].start
            shapes = {name: (rows,) + tuple(shape[1:])
                      for name, shape in data_shapes.items()}
            exe = Executor.simple_bind(sym, c, grad_req=grad_req, **shapes)
            if shared_group is not None:
                shared = shared_group.train_execs[i]
                for n in self.param_names:
                    exe.arg_dict[n] = shared.arg_dict[n]
                    if n in shared.grad_dict:
                        exe.grad_dict[n] = shared.grad_dict[n]
                for n in self.aux_names:
                    exe.aux_dict[n] = shared.aux_dict[n]
            self.train_execs.append(exe)
        self.slices = slices
        self.param_arrays = [[e.arg_dict[n] for e in self.train_execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.train_execs]
                            for n in self.param_names]
        self.aux_arrays = [[e.aux_dict[n] for e in self.train_execs]
                           for n in self.aux_names]
        self.data_arrays = [[(e.arg_dict[n], sl) for e, sl in
                             zip(self.train_execs, self.slices)]
                            for n in self.data_names]
        self.label_arrays = [[(e.arg_dict[n], sl) for e, sl in
                              zip(self.train_execs, self.slices)]
                             for n in self.label_names]

    def load_data_batch(self, data_batch):
        _load_general(data_batch.data, self.data_arrays)
        if data_batch.label:
            _load_general(data_batch.label, self.label_arrays)

    def forward(self, is_train=False):
        for e in self.train_execs:
            e.forward(is_train=is_train)

    def backward(self):
        for e in self.train_execs:
            e.backward()

    def update_metric(self, metric, labels):
        for e, sl in zip(self.train_execs, self.slices):
            metric.update([label[sl] for label in labels], e.outputs)


class DataParallelExecutorManager:
    """The FeedForward-era manager over a list of contexts; with `sym_gen`
    a group a bucket key, sharing the first group's arrays."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        logger = logger or logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError("work_load_list must match the context count")
        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.execgrp = DataParallelExecutorGroup(
            symbol, arg_names, param_names, ctx, self.slices, train_data)
        self.curr_execgrp = None
        if sym_gen is not None:
            self.execgrp_bucket = {
                train_data.default_bucket_key: self.execgrp}

    def install_monitor(self, monitor):
        if self.sym_gen is not None:
            raise NotImplementedError(
                "monitoring is not implemented for bucketing")
        for e in self.execgrp.train_execs:
            monitor.install(e)

    def set_params(self, arg_params, aux_params):
        for e in self.execgrp.train_execs:
            e.copy_params_from(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """The executors' mean parameters and aux states into the given
        dicts (identical parameters when the caller updates every copy
        alike; aux states, BatchNorm's moving statistics, differ by
        slice), on the first executor's device."""
        execs = self.execgrp.train_execs
        dev = execs[0]._ctx.torch_device()
        for names, attr, out in ((self.param_names, "arg_dict", arg_params),
                                 (self.aux_names, "aux_dict", aux_params)):
            for name in names:
                total = sum(getattr(e, attr)[name]._data.to(dev)
                            for e in execs)
                out[name] = NDArray(total / len(execs))

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        if self.sym_gen is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    self.sym_gen(key), self.arg_names, self.param_names,
                    self.ctx, self.slices, data_batch,
                    shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
