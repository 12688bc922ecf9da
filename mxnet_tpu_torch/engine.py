"""Execution engine surface (port of `mxnet_tpu/engine.py`).

Parity: reference `src/engine/` — the threaded dependency engine that
dispatches op closures when their read/write vars clear, giving async
execution and compute/comm overlap.

In the port CUDA's streams are the engine: every op enqueues on the
current stream and returns; work on one stream runs in program order;
host reads (`asnumpy`, `wait_to_read`) block until the value is ready,
and a fault during the run surfaces there. This module keeps the
reference's API surface (the engine-type query, `wait_all`, bulk
scopes) so user code ports cleanly:

- `current_engine_type()` reads MXNET_ENGINE_TYPE; the default is
  "CUDAAsync" (the reference's is "XLAAsync").
- MXNET_ENGINE_TYPE=NaiveEngine (read once, at import) makes every op
  the registry invokes synchronise its device before it returns, for
  debugging: a fault then names the op that caused it. The default path
  pays one module-level flag read an op.
- `wait_all()` synchronises the CUDA devices the port has used.
- `bulk` / `set_bulk_size` are no-ops, as the reference's are.

The reference's `note()` registry of dispatched buffers has no
counterpart: `torch.cuda.synchronize` already waits for all of them.
"""
from __future__ import annotations

import contextlib
import os

import torch

DEFAULT_ENGINE = "CUDAAsync"


def current_engine_type():
    """Parity: MXNET_ENGINE_TYPE (src/engine/engine.cc:32-58)."""
    return os.environ.get("MXNET_ENGINE_TYPE", DEFAULT_ENGINE)


#: every op synchronises its device (read by ndarray's op invocation)
NAIVE = current_engine_type() == "NaiveEngine"


def sync_outputs(res):
    """Synchronise the device of an op's output(s) (NaiveEngine)."""
    first = res[0] if isinstance(res, (tuple, list)) and res else res
    if isinstance(first, torch.Tensor) and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)
    return res


def used_devices():
    """The CUDA device indices holding memory of this process's caching
    allocator (the devices the port has run on)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [i for i in range(torch.cuda.device_count())
            if torch.cuda.memory_reserved(i) > 0]


def wait_all():
    """Parity: Engine::WaitForAll / mx.nd.waitall: block until the work
    enqueued on every device the port has used is done; a fault during
    that work raises here."""
    for i in used_devices():
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def bulk(size):
    """Parity: the engine's bulk scope (threaded_engine.h:398-472). CUDA
    streams already batch the enqueued ops, so this scope does nothing."""
    yield


def set_bulk_size(size):
    return size
