"""Run a torch.nn.Module as a Gluon block (port of
`mxnet_tpu/plugin/torch_module.py`).

Parity: reference `plugin/torch/torch_module.cc` + `torch_function.cc` —
the TorchModule op adapts Torch modules into MXNet graphs, mapping the
module's weights into framework-visible parameter arrays so the MXNet
optimizer trains them.

In the port the module runs natively, on the block's context (the module
is moved there when it is wrapped). Its parameters and buffers ARE the
tensors behind the Gluon `Parameter`s, with no host copy: each call runs
the module through `torch.func.functional_call` on the Parameters'
current tensors, so an optimizer that rebinds a Parameter's value, or a
load of saved parameters, is what the next call computes with, and the
gradients come from torch's autograd straight into the Parameters'
leaves (the reference copies every value through the host both ways,
`mxnet_tpu/plugin/torch_module.py:106-120`). Trainable torch parameters
become `grad_req='write'` Parameters; frozen ones and buffers
(BatchNorm's running statistics) become `grad_req='null'` Parameters,
which a training call updates in place and checkpoints keep.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..context import current_context
from ..gluon.block import Block
from ..initializer import Zero
from ..ndarray import NDArray


class TorchBlock(Block):
    """Wrap a ``torch.nn.Module``; its parameters become Gluon Parameters.

    Example::

        tb = TorchBlock(torch.nn.Linear(4, 2))
        tb(x)                       # forward
        gluon.Trainer(tb.collect_params(), "sgd", ...)  # trains torch weights
    """

    def __init__(self, torch_module, prefix=None, params=None, ctx=None):
        super().__init__(prefix=prefix, params=params)
        if not isinstance(torch_module, torch.nn.Module):
            raise TypeError("TorchBlock wraps a torch.nn.Module, got %s"
                            % type(torch_module).__name__)
        ctx = ctx if ctx is not None else current_context()
        self._module = torch_module.to(ctx.torch_device())
        self._names = {}  # Gluon parameter name -> torch state name

        def _register(tname, tensor, trainable):
            pname = tname.replace(".", "_")
            # the module's own tensor (NDArray narrows an int64 buffer,
            # BatchNorm's num_batches_tracked, to int32, as it does
            # every array)
            data = NDArray(tensor.detach(), ctx=ctx)
            p = self.params.get(pname, shape=data.shape,
                                dtype=str(data._data.dtype)[len("torch."):],
                                allow_deferred_init=False, init=Zero(),
                                grad_req="write" if trainable else "null")
            p._data = data
            if p.grad_req != "null":
                p._init_grad()
            self._reg_params[pname] = p
            self._names[pname] = tname

        for tname, tp in self._module.named_parameters():
            _register(tname, tp, tp.requires_grad)
        for tname, tb in self._module.named_buffers():
            _register(tname, tb, False)

    @property
    def module(self):
        return self._module

    def forward(self, *inputs):
        state = {tname: self._reg_params[pname].data()._data
                 for pname, tname in self._names.items()}
        self._module.train(autograd.is_training())
        args = [a._data if isinstance(a, NDArray) else a for a in inputs]
        with torch.set_grad_enabled(autograd.is_recording()):
            out = torch.func.functional_call(self._module, state,
                                             tuple(args))
        if isinstance(out, (tuple, list)):
            return [NDArray(o) for o in out]
        return NDArray(out)
