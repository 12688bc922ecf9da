"""TrainStep, single device (port of `mxnet_tpu/parallel/trainer.py`
TrainStep).

One call is one optimizer step of a Gluon net: the forward and the loss in
training mode with the parameters as leaves of torch's graph, the mean
loss, the gradients of every parameter whose grad_req is not "null"
through `torch.autograd.grad`, the optimizer's pure rule
(optimizer_rules.py) applied in place under `no_grad`, and the BatchNorm
running stats the forward wrote kept. The reference compiles the same
step into one XLA program and differentiates it with jax.value_and_grad,
running the forward with its own tape off (`_RecordingStateScope(False,
True)`); here torch's graph is what differentiates, so the forward runs
with recording on (`_RecordingStateScope(True, True)`).

`dtype="bfloat16"` computes in bfloat16 over float32 master weights: the
parameters and the input are cast on the way in, so the gradients come
back through the casts in float32, and the logits are cast to float32
before the loss, as the reference does. The parameters are updated where
they live, so `sync_params()` has nothing to write back.

The reference's multi-device and resilience options (a mesh, sharded
optimizer state and update, quantized collectives, the bad-step guard,
rematerialization) belong to later slices of the port: asking for one
raises MXNetError instead of running something else. Not ported yet:
probe, state_dict / load_state_dict, memory_analysis and the lr-schedule
hooks beyond `set_lr_schedule` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import contextlib
import os

import torch

from .. import autograd
from .. import optimizer as _opt_mod
from .. import optimizer_rules as _rules
from ..base import MXNetError, torch_dtype
from ..ndarray import NDArray

_LATER = "a later slice of the port (multi-device and resilient training)"


def _remat_mode(remat):
    """The reference's remat argument / env vars, as none, full or io."""
    if remat is None:
        mode = os.environ.get("MXNET_REMAT_POLICY", "").lower()
        if mode:
            return mode
        return "full" if os.environ.get("MXNET_BACKWARD_DO_MIRROR",
                                        "0") == "1" else "none"
    if remat is True:
        return "full"
    if not remat or remat == "none":
        return "none"
    return remat


@contextlib.contextmanager
def swap_param_buffers(plist, values):
    """Stand `values` in for the parameters' tensors (casts of them, in
    mixed precision) while the forward runs; restore the originals on
    exit. Yields the injected list, so the caller can tell which
    parameters the forward rebound (BatchNorm running stats)."""
    saved = [p._data._data_buf for p in plist]
    injected = list(values)
    try:
        for p, v in zip(plist, injected):
            p._data._data_buf = v  # not through the setter: keep the graph
        yield injected
    finally:
        for p, d in zip(plist, saved):
            p._data._data_buf = d


class TrainStep:
    """Net + loss + optimizer as one step call.

        step = TrainStep(net, loss_fn, 'sgd',
                         {'learning_rate': 0.1, 'momentum': 0.9})
        loss = step(x_batch, y_batch)   # parameters update in place
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, data_axis="dp", param_shardings=None,
                 dtype="float32", remat=None, shard_optimizer_states=False,
                 sharded_update=None, guard=False,
                 quantized_collectives=None):
        if sharded_update is None:
            sharded_update = os.environ.get("MXNET_SHARDED_UPDATE",
                                            "0") == "1"
        if quantized_collectives is None:
            quantized_collectives = os.environ.get(
                "MXNET_QUANTIZED_COLLECTIVES", "").strip() or None
        for what, asked in (("mesh", mesh is not None),
                            ("param_shardings", bool(param_shardings)),
                            ("shard_optimizer_states",
                             bool(shard_optimizer_states)),
                            ("sharded_update", bool(sharded_update)),
                            ("quantized_collectives",
                             quantized_collectives is not None),
                            ("guard", bool(guard))):
            if asked:
                raise MXNetError("TrainStep(%s=...) is not ported yet: it "
                                 "comes with %s" % (what, _LATER))
        mode = _remat_mode(remat)
        if mode != "none":
            raise MXNetError("TrainStep remat=%r is not ported yet: it comes "
                             "with %s" % (mode, _LATER))
        if isinstance(optimizer, str):
            optimizer = _opt_mod.create(optimizer,
                                        **dict(optimizer_params or {}))
        elif optimizer_params:
            raise ValueError("pass optimizer_params only with a string name")
        if optimizer.rule_name is None:
            raise ValueError("optimizer %s has no pure update rule"
                             % type(optimizer).__name__)
        self._net = net
        self._loss = loss_fn
        self._opt = optimizer
        self._compute_dtype = torch_dtype(dtype)
        self._lr_schedule = None
        self._t = 0
        self._plist = None

    def set_lr_schedule(self, fn):
        self._lr_schedule = fn

    @property
    def t(self):
        """Completed optimizer steps."""
        return self._t

    def _build(self):
        params = self._net.collect_params()
        names, plist = [], []
        for n, p in params.items():
            if p._data is None:
                raise MXNetError("initialize parameters before TrainStep "
                                 "(missing %s)" % n)
            names.append(n)
            plist.append(p)
        opt = self._opt
        init_rule, self._apply_rule = _rules.get(opt.rule_name)
        self._hyper = opt.rule_hyper()
        self._grad_mask = [p.grad_req != "null" for p in plist]

        # Parameter attributes take priority over the optimizer's name
        # dicts, as in the reference's build
        def _mult(p, n, dct, attr):
            v = getattr(p, attr, 1.0)
            return v if v != 1.0 else dct.get(n, 1.0)

        gparams = [(n, p) for n, p, m in zip(names, plist, self._grad_mask)
                   if m]
        self._lr_mults = [_mult(p, n, opt.lr_mult, "lr_mult")
                          for n, p in gparams]
        self._wd_mults = [_mult(p, n, opt.wd_mult, "wd_mult")
                          for n, p in gparams]
        with torch.no_grad():
            self._opt_state = [init_rule(p._data._data.detach(), self._hyper)
                               for _, p in gparams]
        self._names = names
        self._plist = plist

    def _lr(self):
        if self._lr_schedule is not None:
            return self._lr_schedule(self._t)
        if self._opt.lr_scheduler is not None:
            return self._opt.lr_scheduler(self._t)
        return self._opt.lr

    def _forward_backward(self, x, y):
        """(mean loss, grads of the grad_req != "null" parameters, {plist
        index: the value the forward wrote}) for the batch (x, y), with
        nothing written back."""
        if self._plist is None:
            self._build()
        plist, mask = self._plist, self._grad_mask
        dev = plist[0]._data._data.device if plist else None
        xv = (x._data if isinstance(x, NDArray) else torch.as_tensor(x))
        yv = (y._data if isinstance(y, NDArray) else torch.as_tensor(y))
        xv, yv = xv.detach().to(dev), yv.detach().to(dev)
        cdtype = self._compute_dtype
        mixed = cdtype != torch.float32

        def compute(t):
            return t.to(cdtype) if mixed and t.is_floating_point() else t

        leaves = [p._data._data.detach().requires_grad_(True)
                  for p, m in zip(plist, mask) if m]
        merged, li = [], 0
        for p, m in zip(plist, mask):
            if m:
                merged.append(compute(leaves[li]))
                li += 1
            else:
                merged.append(compute(p._data._data.detach()))
        with swap_param_buffers(plist, merged) as injected:
            with autograd._RecordingStateScope(True, True):
                out = self._net.forward(NDArray(compute(xv)))
                if mixed:
                    # the loss in float32, for numerical stability
                    out = NDArray(out._data.float())
                loss = self._loss(out, NDArray(yv))
                loss_val = torch.mean(loss._data.float())
            aux_upd = {i: p._data._data_buf for i, p in enumerate(plist)
                       if p._data._data_buf is not injected[i]}
        grads = torch.autograd.grad(loss_val, leaves, allow_unused=True)
        return loss_val.detach(), grads, aux_upd

    def loss_and_grads(self, x, y):
        """The step's forward, loss and gradients on (x, y) without the
        update: (mean loss, {name: gradient}) over the parameters whose
        grad_req is not "null". Nothing is written: not the parameters,
        the optimizer state, the running stats or the step count."""
        loss, grads, _ = self._forward_backward(x, y)
        gparams = [(n, p) for n, p, m in zip(self._names, self._plist,
                                             self._grad_mask) if m]
        return loss, {n: torch.zeros_like(p._data._data) if g is None
                      else g.detach() for (n, p), g in zip(gparams, grads)}

    def __call__(self, x, y):
        """One step on the batch (x, y); returns the mean loss, a float32
        0-d tensor on the parameters' device."""
        loss_val, grads, aux_upd = self._forward_backward(x, y)
        plist, mask = self._plist, self._grad_mask
        self._t += 1
        lr = self._lr()
        opt = self._opt
        with torch.no_grad():
            gi = 0
            for i, (p, m) in enumerate(zip(plist, mask)):
                w = p._data._data
                if not m:
                    if i in aux_upd:
                        w.copy_(aux_upd[i].to(w.dtype))
                    continue
                g = grads[gi]
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                g = g * opt.rescale_grad
                if opt.clip_gradient is not None:
                    g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
                state = self._opt_state[gi]
                w2, s2 = self._apply_rule(
                    w, g, state, lr * self._lr_mults[gi],
                    opt.wd * self._wd_mults[gi], self._t, self._hyper)
                w.copy_(w2)
                for s, v in zip(state, s2):
                    s.copy_(v)
                gi += 1
        return loss_val

    def sync_params(self):
        """Nothing to do: the parameters are updated where they live (the
        reference keeps them in the compiled step until this call)."""
