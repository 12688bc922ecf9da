"""TrainStep, single device (port of `mxnet_tpu/parallel/trainer.py`
TrainStep).

One call is one optimizer step of a Gluon net: the forward and the loss in
training mode with the parameters as leaves of torch's graph, the mean
loss, the gradients of every parameter whose grad_req is not "null"
through `torch.autograd.grad`, the optimizer's pure rule
(optimizer_rules.py; every registered optimizer has one) applied in place
under `no_grad`, and the BatchNorm running stats the forward wrote kept.
The reference compiles the same step into one XLA program and
differentiates it with jax.value_and_grad, running the forward with its
own tape off (`_RecordingStateScope(False, True)`); here torch's graph is
what differentiates, so the forward runs with recording on
(`_RecordingStateScope(True, True)`).

`dtype="bfloat16"` computes in bfloat16 over float32 master weights: the
parameters and the input are cast on the way in, so the gradients come
back through the casts in float32, and the logits are cast to float32
before the loss, as the reference does. The parameters are updated where
they live, so `sync_params()` has nothing to write back.

`remat=True` / "full" (or MXNET_BACKWARD_DO_MIRROR=1) runs each compute
block of the net (`_remat_segments`) through torch's non-reentrant
checkpoint: the backward recomputes the segment's activations instead of
keeping them. remat="io" (or MXNET_REMAT_POLICY=io) keeps the
convolution and matmul outputs and the BatchNorm batch statistics from
the first run and recomputes only the elementwise chains
(ops/remat.py). Each segment is a function of explicit inputs, as the
reference's: its input, its parameters' values and its aux values, so
the recompute sees this step's weights, drops the running-stat writes it
repeats, and draws the same dropout masks (the port's generators are
saved before a segment's first run and put back around its recompute).

`guard=True` computes the global gradient norm in float32 and the flag
isfinite(loss) & isfinite(norm) on the device, and a bad step keeps the
parameters, the optimizer state and the running stats as they were
(`torch.where`, no host sync). `probe`, `state_dict` /
`load_state_dict` and `memory_analysis` follow the reference.

The chaos seam: every gradient gets `utils.chaos.grad_poison(t)` added
ahead of the guard's check and norm, as in the reference's step (NaN on
an armed `nan_step`, 1e6 on an armed `spike_step`); on a real step the
poison is 0.0 and the add is skipped on the host. Every rank reads the
same environment, so every rank takes the same branch.

Under a mesh (`mesh=`, `data_axis=`) every rank runs the step on its
slice of the global batch it is given (`mesh.shard_batch` over
`data_axis`); a training-mode BatchNorm takes the global batch's
statistics (its per-channel partials reduced over the data axis, as the
reference's GSPMD step computes them); the loss and the gradients are
averaged over the data axis, so every rank applies the same update and
the values are the unsharded step's.

- `param_shardings` ({name: PartitionSpec}) is met gather-on-use, in the
  FSDP manner: the rank keeps its shard of the parameter's optimizer
  state and updates only its shard, and the updated shards are gathered
  back into the parameter the forward reads. Compute is placed otherwise
  than under GSPMD, which partitions the matmuls themselves: here each
  rank runs the whole forward on its batch slice (the values are the
  same).
- `shard_optimizer_states` keeps, of each replicated weight's optimizer
  state, the 1/N slice along its first axis that divides by the data
  axis' size N (ZeRO-1's placement); `sharded_update` (or
  MXNET_SHARDED_UPDATE=1) also reduce-scatters the gradient: the rank
  updates its 1/N of weight, gradient and state and all-gathers the
  weight. A rule's whole-tensor norms (lbsgd's ||w||, ||g||) are summed
  over the data axis from the shards' squared partials. The stochastic
  rule (sgld) updates whole tensors, so its draws match the unsharded
  step's.
- `quantized_collectives="int8"` (or MXNET_QUANTIZED_COLLECTIVES=int8)
  sums the gradients over the data axis as int8: each rank quantizes its
  gradient plus its error-feedback carry onto a grid shared by all ranks
  (the scale from a max-reduction of the amaxes), capped at 127 // N a
  rank so that the int8 sum of N addends stays in range; the error it
  drops is carried into the next step. As in the reference, this path's
  BatchNorm statistics are each rank's own, averaged over the data axis
  after the step; an ineligible configuration (no data axis of more
  than one rank, sharded_update, tensor-sharded parameters) records why
  on `collective_quant_fallback` and runs the float collective.

Without a mesh, `shard_optimizer_states` and `sharded_update` change
nothing, as in the reference (there is no data axis to shard over).

The step registers at the compile watchdog's site "train.step" (and the
probe at "train.probe"), keyed by the batch's signature: a new one is a
first run, timed and, on the card, measured. Its footprint (the device's
peak allocation over the forward and backward) meets MXNET_HBM_BUDGET_GB
BEFORE the optimizer update, so a refused step leaves the parameters, the
optimizer state, the running stats and the step count untouched; a mesh
step's first run also fills the comms ledger (`introspect.site_comms(
"train.step")`). `warm_loads` counts the kernel libraries the step's
calls loaded from the AOT cache (mxnet_tpu_torch/aot).
"""
from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .. import autograd
from .. import optimizer as _opt_mod
from .. import optimizer_rules as _rules
from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..telemetry import introspect as _introspect
from ..ndarray import NDArray
from ..ops import remat as _remat
from ..utils import chaos as _chaos
from .collectives import (_Axis, all_gather_raw, all_reduce_flat,
                          all_reduce_raw, data_axis_scope,
                          reduce_scatter_raw)
from .functional import swap_param_buffers
from .mesh import P, shard_batch, use_mesh

_REMAT_MODES = ("full", "io")


def _remat_mode(remat):
    """The remat argument / env vars, as "none", "full" or "io"."""
    if remat is None:
        mode = os.environ.get("MXNET_REMAT_POLICY", "").lower()
        if mode:
            if mode != "none" and mode not in _REMAT_MODES:
                raise ValueError("MXNET_REMAT_POLICY must be none, full or "
                                 "io, got %r" % (mode,))
            return mode
        return "full" if os.environ.get("MXNET_BACKWARD_DO_MIRROR",
                                        "0") == "1" else "none"
    if remat is True:
        return "full"
    if not remat or remat == "none":
        return "none"
    if remat in _REMAT_MODES:
        return remat
    raise ValueError("remat must be bool, 'none', 'full' or 'io', got %r"
                     % (remat,))


def _remat_segments(net):
    """The checkpoint segments: the blocks of the tree, recursing through
    Sequential and HybridSequential containers, so that boundaries fall
    at real compute blocks (a ResNet's bottlenecks, an MLP's Dense
    layers)."""
    from ..gluon.nn.basic_layers import HybridSequential, Sequential
    segs = []

    def walk(block):
        for child in getattr(block, "_children", {}).values():
            if isinstance(child, (Sequential, HybridSequential)):
                walk(child)
            else:
                segs.append(child)

    walk(net)
    return segs


class _SavedBytes:
    """The distinct storages autograd saved for backward during a step,
    counted through `torch.autograd.graph.saved_tensors_hooks`, plus what
    remat keeps (segment inputs, the tensors remat "io" tags). The step's
    arguments (parameters, batch) are not counted."""

    def __init__(self, exclude):
        self._exclude = set(exclude)
        self._seen = {}

    def add(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr not in self._exclude and ptr not in self._seen:
            self._seen[ptr] = st.nbytes()

    def _pack(self, t):
        self.add(t)
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        lambda t: t)

    @property
    def total(self):
        return sum(self._seen.values())


def _storage_ptr(t):
    return t.untyped_storage().data_ptr()


class _Segment:
    """One checkpointed call of a segment: the generator states and the
    recording / training scope at its first run, and under "io" the
    tensors that run tagged. The recompute runs in the backward, after
    the step's scopes have exited, so it enters them again."""

    def __init__(self, mode, saved):
        self.keep = mode == "io"
        self.store = {}
        self.saved = saved
        self.rng = None
        self.scope = None

    @contextlib.contextmanager
    def _first_run(self):
        self.rng = _random.snapshot()
        self.scope = (autograd.is_recording(), autograd.is_training())
        if self.keep:
            on_keep = self.saved.add if self.saved is not None else None
            with _remat.record(self.store, on_keep):
                yield
        else:
            yield

    @contextlib.contextmanager
    def _recompute(self):
        now = _random.snapshot()
        _random.restore(self.rng)
        try:
            with autograd._RecordingStateScope(*self.scope):
                if self.keep:
                    with _remat.replay(self.store):
                        yield
                else:
                    yield
        finally:
            _random.restore(now)

    def contexts(self):
        return self._first_run(), self._recompute()


@contextlib.contextmanager
def _segment_remat(blocks, mode, net, saved=None):
    """Run each block of `blocks` through torch's non-reentrant
    checkpoint while the step's forward runs. A block's checkpointed
    function takes its input, its parameters' values and its aux values
    explicitly (the values injected for the step, so the recompute, which
    runs after the step's swap has exited, sees them), writes them into
    the parameters for the run, and returns the output and the aux values
    the run wrote; those of the first run are written back into the same
    NDArrays (references taken before the step stay valid), those of the
    recompute are dropped. Hybridized blocks anywhere in `net` are
    deactivated for the step, so no cached graph bypasses a segment."""
    active = []

    def _collect_active(b):
        if getattr(b, "_active", False):
            active.append(b)
            b._active = False

    if net is not None and hasattr(net, "apply"):
        net.apply(_collect_active)
    wrapped_blocks = []  # (block, its own forward attribute or None)
    for block in blocks:
        _collect_active(block)
        orig = block.forward
        params = list(block.collect_params().values())
        aux_idx = [i for i, p in enumerate(params) if p.grad_req == "null"]

        def wrapped(*args, _orig=orig, _params=params, _aux_idx=aux_idx):
            if len(args) != 1 or not isinstance(args[0], NDArray):
                return _orig(*args)
            xv = args[0]._data
            _random.generator(xv.device)  # made before the snapshot
            seg = _Segment(mode, saved)
            if saved is not None:
                saved.add(xv)

            def pure(x_in, *values):
                with swap_param_buffers(_params, values):
                    out = _orig(NDArray(x_in))
                    aux_out = tuple(_params[i]._data._data_buf
                                    for i in _aux_idx)
                outs = (out._data if isinstance(out, NDArray)
                        else tuple(o._data for o in out))
                return outs, aux_out

            res, aux_out = _checkpoint(
                pure, xv, *[p._data._data_buf for p in _params],
                use_reentrant=False, context_fn=seg.contexts,
                preserve_rng_state=False)
            for i, v in zip(_aux_idx, aux_out):
                _params[i]._data._data_buf = v
            if isinstance(res, tuple):
                return tuple(NDArray(r) for r in res)
            return NDArray(res)

        wrapped_blocks.append((block, block.__dict__.get("forward")))
        block.forward = wrapped
    try:
        yield
    finally:
        for block, own in wrapped_blocks:
            if own is None:
                del block.forward  # the class's method again
            else:
                block.forward = own
        for block in active:
            block._active = True


class MemoryAnalysis:
    """The step's memory, under the field names of XLA's
    CompiledMemoryStats that the reference returns: arguments (parameters,
    non-grad values, optimizer state, batch), outputs (the updated state
    and the loss), aliases (the state updated in place), and temps (what
    autograd saved for backward during the last step, remat's kept
    tensors included). `peak_bytes` is the card's
    `torch.cuda.max_memory_allocated` over the last step, None on the
    CPU."""

    def __init__(self, argument, output, alias, temp, peak):
        self.argument_size_in_bytes = argument
        self.output_size_in_bytes = output
        self.alias_size_in_bytes = alias
        self.temp_size_in_bytes = temp
        self.generated_code_size_in_bytes = 0
        self.host_argument_size_in_bytes = 0
        self.host_output_size_in_bytes = 0
        self.host_alias_size_in_bytes = 0
        self.host_temp_size_in_bytes = 0
        self.peak_bytes = peak

    def __repr__(self):
        return ("MemoryAnalysis(argument=%d, output=%d, alias=%d, temp=%d, "
                "peak=%r)" % (self.argument_size_in_bytes,
                              self.output_size_in_bytes,
                              self.alias_size_in_bytes,
                              self.temp_size_in_bytes, self.peak_bytes))


def _nbytes(t):
    return t.numel() * t.element_size()


class Shard:
    """This rank's block of a tensor kept sharded over the mesh, as
    `TrainStep.state_dict(device=True)` hands out sharded optimizer
    state: `data` (the live block), `shape` and `dtype` of the whole
    tensor, `index` (the block's (start, stop) in each dimension of the
    whole), `shard` of `shards` (its place among the distinct blocks in
    sorted index order), `holders` (the global ranks that keep the same
    block, sorted), `spec` (the layout, as text) and `mesh_axes` ({axis:
    size}). A checkpoint manager writes each distinct block once from
    these, without asking the other ranks."""

    __slots__ = ("data", "shape", "dtype", "index", "shard", "shards",
                 "holders", "spec", "mesh_axes")

    def __init__(self, data, shape, index, shard, shards, holders, spec,
                 mesh_axes):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.dtype = data.dtype
        self.index = tuple((int(a), int(b)) for a, b in index)
        self.shard = int(shard)
        self.shards = int(shards)
        self.holders = [int(r) for r in holders]
        self.spec = spec
        self.mesh_axes = dict(mesh_axes)

    def __repr__(self):
        return "Shard(%s of %s, block %d of %d at %s)" % (
            tuple(self.data.shape), self.shape, self.shard, self.shards,
            self.index)


def _to_host(t):
    """A numpy copy of `t` (bfloat16, which numpy lacks, as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


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
        self._mesh = mesh
        self._data_axis = data_axis
        self._param_shardings = dict(param_shardings or {})
        self._sharded_update = bool(sharded_update)
        self._shard_opt = bool(shard_optimizer_states) or \
            self._sharded_update
        self._qcoll_req = quantized_collectives
        self.collective_quant = None
        self.collective_quant_fallback = None
        self._quant_residuals = None
        self._remat = _remat_mode(remat)
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
        self._guard = bool(guard)
        self.last_step_ok = None     # device bool of the latest step
        self.last_grad_norm = None   # device float32 of the latest step
        self._lr_schedule = None
        self._t = 0
        self._plist = None
        self._temp_bytes = None
        self._peak_bytes = None
        self._batch_bytes = 0
        self._warm_loads = 0
        self._site = _introspect.instrument(
            self._step, site="train.step", argnames=("x", "y"),
            phase="train")
        self._probe_site = _introspect.instrument(
            self._probe, site="train.probe", argnames=("x", "y"),
            phase="train", sig_argnums=(0, 1))

    def set_lr_schedule(self, fn):
        self._lr_schedule = fn

    @property
    def t(self):
        """Completed optimizer steps (the checkpoint step number)."""
        return self._t

    @property
    def warm_loads(self):
        """Kernel libraries this step's calls loaded from the AOT cache
        (mxnet_tpu_torch/aot) instead of building them."""
        return self._warm_loads

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
        self._build_layouts(gparams)
        with torch.no_grad():
            self._opt_state = []
            self._state_sharded = []
            for (_, p), lay in zip(gparams, self._layouts):
                w = p._data._data.detach()
                st = init_rule(w, self._hyper)
                sharded = [lay is not None and tuple(v.shape) ==
                           tuple(w.shape) and v.dim() > 0 for v in st]
                self._opt_state.append(tuple(
                    self._local(lay, v).clone() if sh else v
                    for v, sh in zip(st, sharded)))
                self._state_sharded.append(sharded)
        self._names = names
        self._plist = plist
        if self._remat != "none":
            self._remat_blocks = _remat_segments(self._net) or [self._net]

    def _build_layouts(self, gparams):
        """Each gradient parameter's update layout: None (the whole
        tensor on every rank), ("zero", dim) (its 1/N along dim over the
        data axis) or ("spec", PartitionSpec) (its param_shardings
        block); and the int8 collective's eligibility, as the
        reference's build decides them."""
        mesh, dp_ax = self._mesh, self._data_axis
        dp_size = mesh.shape.get(dp_ax, 0) if (mesh is not None and dp_ax) \
            else 0
        self._dp = _Axis(mesh, dp_ax) if dp_size > 1 else None
        stochastic = self._opt.rule_name in _rules.STOCHASTIC
        layouts = []
        for n, p in gparams:
            w = p._data._data
            spec = self._param_shardings.get(n, P())
            lay = None
            if mesh is not None and any(mesh.axis_size(e) > 1
                                        for e in spec if e is not None):
                lay = ("spec", P(*spec))
            elif self._shard_opt and dp_size > 1 and \
                    all(e is None for e in spec):
                for axis in range(w.dim()):
                    if w.shape[axis] % dp_size == 0:
                        lay = ("zero", axis)
                        break
            layouts.append(None if stochastic else lay)
        self._layouts = layouts
        self._szd = self._sharded_update and dp_size > 1 and \
            any(lay is not None and lay[0] == "zero" for lay in layouts)
        self.collective_quant = None
        self.collective_quant_fallback = None
        if self._qcoll_req:
            if str(self._qcoll_req) != "int8":
                raise ValueError(
                    "MXNET_QUANTIZED_COLLECTIVES must be int8 or unset, got "
                    "%r" % (self._qcoll_req,))
            if dp_size <= 1:
                self.collective_quant_fallback = (
                    "needs a data-parallel mesh (dp > 1); a single-chip "
                    "step has no gradient collective to compress")
            elif self._sharded_update:
                self.collective_quant_fallback = (
                    "sharded_update reshapes the grad all-reduce into "
                    "reduce-scatter + all-gather (ZeRO-1); int8 "
                    "compression targets the replicated all-reduce")
            elif any(any(e is not None for e in
                         self._param_shardings.get(n, P()))
                     for n, _ in gparams):
                self.collective_quant_fallback = (
                    "tensor-sharded parameters reduce over their own "
                    "mesh axes; int8 compression targets "
                    "replicated-parameter dp gradients")
            else:
                self.collective_quant = "int8"

    def _local(self, lay, t):
        """This rank's block of the whole tensor t under a layout."""
        if lay is None:
            return t
        if lay[0] == "zero":
            dim, n = lay[1], self._dp.size
            size = t.shape[dim] // n
            return t.narrow(dim, self._dp.index * size, size)
        return t[self._mesh.shard_slices(tuple(t.shape), lay[1])]

    def _gather(self, lay, t):
        """The whole tensor from every rank's block under a layout."""
        if lay is None:
            return t
        if lay[0] == "zero":
            return all_gather_raw(t, self._dp, lay[1])
        for dim, entry in enumerate(lay[1]):
            if entry is not None and self._mesh.axis_size(entry) > 1:
                t = all_gather_raw(t, _Axis(self._mesh, entry), dim)
        return t

    def _layout_spec(self, lay, ndim):
        """A layout as a PartitionSpec of `ndim` entries."""
        if lay[0] == "zero":
            spec = [None] * ndim
            spec[lay[1]] = self._data_axis
            return P(*spec)
        return P(*(tuple(lay[1]) + (None,) * (ndim - len(lay[1]))))

    def _block_index(self, lay, shape, coords):
        """The (start, stop) of each dimension of the block that the rank
        at mesh coordinates `coords` keeps under a layout."""
        mesh = self._mesh

        def index(names):
            i = 0
            for a in mesh.axis_names:
                if a in names:
                    i = i * mesh.shape[a] + coords[a]
            return i

        out = []
        for dim, entry in zip(shape, self._layout_spec(lay, len(shape))):
            names = mesh._names(entry)
            n = mesh.axis_size(names)
            if n == 1:
                out.append((0, int(dim)))
            else:
                size = dim // n
                i = index(names)
                out.append((i * size, (i + 1) * size))
        return tuple(out)

    def _shard(self, lay, t, shape):
        """The `Shard` descriptor of this rank's block `t` of a tensor of
        `shape` under a layout."""
        mesh = self._mesh
        blocks = {}
        for pos in np.ndindex(*mesh.devices.shape):
            coords = dict(zip(mesh.axis_names, pos))
            blocks.setdefault(self._block_index(lay, shape, coords),
                              []).append(int(mesh.devices[pos]))
        mine = self._block_index(lay, shape, mesh.coords)
        order = sorted(blocks)
        return Shard(t, shape, mine, order.index(mine), len(order),
                     sorted(blocks[mine]),
                     repr(self._layout_spec(lay, len(shape))), mesh.shape)

    def _norm_axis(self, lay):
        """The group a layout's block norms sum over."""
        if lay is None:
            return None
        if lay[0] == "zero":
            return self._dp
        return _Axis(self._mesh, lay[1].axes())

    def _shard_inputs(self, x, y):
        """This rank's slice of the global batch over the data axis."""
        if self._mesh is None or self._dp is None:
            return x, y
        return (shard_batch(self._mesh, x, self._data_axis),
                shard_batch(self._mesh, y, self._data_axis))

    def _mesh_scope(self):
        """The mesh current, and BatchNorm over the data axis (not under
        the int8 collective, whose statistics are each rank's own)."""
        stack = contextlib.ExitStack()
        if self._mesh is not None:
            stack.enter_context(use_mesh(self._mesh))
            if not self.collective_quant:
                stack.enter_context(data_axis_scope(self._mesh,
                                                    self._data_axis))
        return stack

    def _reduce(self, loss, grads, aux_upd, full=False):
        """The loss, gradients and BatchNorm writes of the global batch
        from this rank's: averaged over the data axis (equal slices).
        Under sharded_update a zero-laid gradient stays this rank's own,
        reduce-scattered in the update, unless `full`."""
        dp = self._dp
        if dp is None:
            return loss, grads, aux_upd
        loss = all_reduce_raw(loss, dp) / dp.size
        if self.collective_quant:
            aux_upd = {i: all_reduce_raw(v.float(), dp).div_(dp.size)
                       .to(v.dtype) for i, v in aux_upd.items()}
            if not full:
                return loss, self._int8_allreduce(grads), aux_upd
        lays = self._layouts
        idx = [i for i in range(len(grads))
               if full or not (self._szd and lays[i] is not None
                               and lays[i][0] == "zero")]
        out = list(grads)
        for i, total in zip(idx, all_reduce_flat([grads[i] for i in idx],
                                                 dp)):
            out[i] = total / dp.size
        return loss, out, aux_upd

    def _int8_allreduce(self, grads):
        """The data axis' mean gradients through an int8 sum with error
        feedback (module docstring): one max-reduction of the amaxes,
        one int8 allreduce of every gradient at once."""
        dp = self._dp
        cap = float(max(1, 127 // dp.size))
        if self._quant_residuals is None:
            self._quant_residuals = [torch.zeros(g.shape, dtype=torch.float32,
                                                 device=g.device)
                                     for g in grads]
        gfs = [g.float() + r for g, r in zip(grads, self._quant_residuals)]
        amax = all_reduce_raw(torch.stack([gf.abs().amax() for gf in gfs]),
                              dp, op="max")
        scales = torch.clamp(amax, min=1e-30) / cap
        qs, res = [], []
        for gf, sc in zip(gfs, scales):
            q = torch.clamp(torch.round(gf / sc), -cap, cap).to(torch.int8)
            res.append(gf - q.float() * sc)
            qs.append(q)
        total = all_reduce_raw(torch.cat([q.reshape(-1) for q in qs]), dp)
        self._quant_residuals = res
        return [(piece.float() * sc / dp.size).view_as(g).to(g.dtype)
                for piece, sc, g in zip(torch.split(
                    total, [g.numel() for g in grads]), scales, grads)]

    def _lr(self):
        if self._lr_schedule is not None:
            return self._lr_schedule(self._t)
        if self._opt.lr_scheduler is not None:
            return self._opt.lr_scheduler(self._t)
        return self._opt.lr

    def _grad_vals(self):
        return [p._data._data for p, m in zip(self._plist, self._grad_mask)
                if m]

    def _nograd_vals(self):
        return [p._data._data for p, m in zip(self._plist, self._grad_mask)
                if not m]

    def _forward_backward(self, x, y, measure=False):
        """(mean loss, grads of the grad_req != "null" parameters, {plist
        index: the value the forward wrote}) for the batch (x, y), with
        nothing written back. `measure` counts the bytes saved for
        backward into `_temp_bytes`."""
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
        saved = None
        if measure:
            saved = _SavedBytes(
                [_storage_ptr(t) for t in [xv, yv] + leaves
                 + [p._data._data for p in plist]])
            self._batch_bytes = _nbytes(xv) + _nbytes(yv)
        remat_ctx = (_segment_remat(self._remat_blocks, self._remat,
                                    self._net, saved)
                     if self._remat != "none" else contextlib.nullcontext())
        hooks = saved.hooks() if saved is not None \
            else contextlib.nullcontext()
        with swap_param_buffers(plist, merged) as injected:
            with autograd._RecordingStateScope(True, True), remat_ctx, \
                    hooks:
                out = self._net.forward(NDArray(compute(xv)))
                if mixed:
                    # the loss in float32, for numerical stability
                    out = NDArray(out._data.float())
                loss = self._loss(out, NDArray(yv))
                loss_val = torch.mean(loss._data.float())
            aux_upd = {i: p._data._data_buf for i, p in enumerate(plist)
                       if p._data._data_buf is not injected[i]}
        if saved is not None:
            self._temp_bytes = saved.total
        grads = torch.autograd.grad(loss_val, leaves, allow_unused=True)
        return loss_val.detach(), grads, aux_upd

    def loss_and_grads(self, x, y):
        """The step's forward, loss and gradients on (x, y) without the
        update: (mean loss, {name: gradient}) over the parameters whose
        grad_req is not "null". Nothing is written: not the parameters,
        the optimizer state, the running stats or the step count."""
        loss, grads = self._global_loss_and_grads(x, y)
        gparams = [(n, p) for n, p, m in zip(self._names, self._plist,
                                             self._grad_mask) if m]
        return loss, {n: g.detach() for (n, _), g in zip(gparams, grads)}

    def _global_loss_and_grads(self, x, y):
        """(loss, gradients) of the global batch (x, y), every gradient
        whole, nothing written."""
        if self._plist is None:
            self._build()
        x, y = self._shard_inputs(x, y)
        with self._mesh_scope():
            loss, grads, aux = self._forward_backward(x, y)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(self._grad_vals(), grads)]
        loss, grads, _ = self._reduce(loss, grads, aux, full=True)
        return loss, grads

    @staticmethod
    def _global_norm(grads):
        """sqrt of the sum of squares of every gradient, in float32, on
        the device."""
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))

    def __call__(self, x, y):
        """One step on the batch (x, y); returns the mean loss, a float32
        0-d tensor on the parameters' device. A new batch signature is a
        first run at the watchdog's site "train.step"; one the HBM budget
        refuses raises HbmBudgetExceeded with nothing written."""
        if self._plist is None:
            self._build()
        dev = self._plist[0]._data._data.device if self._plist else None
        on_card = dev is not None and dev.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        wmark = _introspect.dispatch_warm_mark()
        try:
            sig = self._site.signature_of((x, y))
            if self._site.seen(sig):
                return self._step(x, y, dev)
            with self._site.first_run(sig, "train", (x, y),
                                      device=dev) as run:
                return self._step(x, y, dev, run)
        finally:
            self._warm_loads += _introspect.dispatch_warm_loads_since(wmark)

    def _step(self, x, y, dev, run=None):
        on_card = dev is not None and dev.type == "cuda"
        x, y = self._shard_inputs(x, y)
        with self._mesh_scope():
            loss_val, grads, aux_upd = self._forward_backward(x, y,
                                                              measure=True)
        plist, mask = self._plist, self._grad_mask
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(self._grad_vals(), grads)]
        loss_val, grads, aux_upd = self._reduce(loss_val, grads, aux_upd)
        if run is not None:
            # a new signature's footprint meets the HBM budget before the
            # update writes anything
            self._site.gate(run)
        self._t += 1
        poison = _chaos.grad_poison(self._t)
        if poison:      # 0.0 on every real step; NaN and 1e6 are true
            grads = [g + poison for g in grads]
        lr = self._lr()
        opt = self._opt
        guard = self._guard
        with torch.no_grad():
            # the gradient each update takes: whole, or this rank's block
            # (reduce-scattered over the data axis under sharded_update)
            upd_g, shard_sq = [], []
            for g, lay in zip(grads, self._layouts):
                if lay is not None and lay[0] == "zero" and self._szd:
                    g = reduce_scatter_raw(g, self._dp, lay[1]) / \
                        self._dp.size
                    shard_sq.append(torch.sum(torch.square(g.float())))
                upd_g.append(g)
            if guard:
                sq = sum(torch.sum(torch.square(g.float()))
                         for g, lay in zip(grads, self._layouts)
                         if not (self._szd and lay is not None
                                 and lay[0] == "zero"))
                if shard_sq:
                    sq = sq + all_reduce_raw(torch.stack(shard_sq).sum(),
                                             self._dp)
                gnorm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32,
                                                   device=loss_val.device))
                ok = torch.isfinite(loss_val) & torch.isfinite(gnorm)
            gi = 0
            for i, (p, m) in enumerate(zip(plist, mask)):
                w = p._data._data
                if not m:
                    if i in aux_upd:
                        upd = aux_upd[i].to(w.dtype)
                        if guard:  # the running stats roll back too
                            upd = torch.where(ok, upd, w)
                        w.copy_(upd)
                    continue
                lay = self._layouts[gi]
                g = upd_g[gi]
                if lay is not None:
                    if not (lay[0] == "zero" and self._szd):
                        g = self._local(lay, g)
                    w_whole, w = w, self._local(lay, w)
                g = g.to(w.dtype) * opt.rescale_grad
                if opt.clip_gradient is not None:
                    g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
                state = self._opt_state[gi]
                with _rules.sharded_norms(self._norm_axis(lay)):
                    w2, s2 = self._apply_rule(
                        w, g, state, lr * self._lr_mults[gi],
                        opt.wd * self._wd_mults[gi], self._t, self._hyper)
                if guard:
                    # a bad step drops the whole update: the weight and
                    # the optimizer state stay as they were
                    w2 = torch.where(ok, w2, w)
                    s2 = [torch.where(ok, a, b) for a, b in zip(s2, state)]
                # the state first: a rule may keep the old weight in it
                # (DCASGD), which the weight's copy would overwrite
                for s, v in zip(state, s2):
                    s.copy_(v)
                if lay is None:
                    w.copy_(w2)
                else:
                    w_whole.copy_(self._gather(lay, w2))
                gi += 1
        if guard:
            self.last_step_ok, self.last_grad_norm = ok, gnorm
        if on_card:
            self._peak_bytes = torch.cuda.max_memory_allocated(dev)
        return loss_val

    def probe(self, x, y, seed=0):
        """(loss, global gradient norm) of the batch as floats, with the
        stochastic layers drawing from generators seeded by `seed`; it
        changes nothing: not the parameters, the optimizer state, the step
        count, the running stats or the generators. Two probes of one
        batch and seed are bit-identical: on CUDA it runs with
        `torch.backends.cudnn.deterministic = True` (and benchmark off)
        for its duration, since cuDNN's weight-gradient algorithms are
        not deterministic run to run. The reference uses the probe to
        cross-check replicas for silent data corruption."""
        if self._plist is None:
            self._build()
        return self._probe_site(x, y, seed)

    def _probe(self, x, y, seed):
        snap = _random.snapshot()
        cudnn = torch.backends.cudnn
        prior = (cudnn.deterministic, cudnn.benchmark)
        try:
            # no generator yet, each made on first use from `seed`
            _random.restore((int(seed) & 0x7FFFFFFF, {}))
            cudnn.deterministic, cudnn.benchmark = True, False
            loss, grads = self._global_loss_and_grads(x, y)
            gnorm = self._global_norm(grads)
            return float(loss), float(gnorm)
        finally:
            cudnn.deterministic, cudnn.benchmark = prior
            _random.restore(snap)

    def memory_analysis(self):
        """The last step's memory (`MemoryAnalysis`); needs one step
        first. `temp_size_in_bytes` is what remat shrinks."""
        if self._temp_bytes is None:
            raise RuntimeError("run at least one step first")
        state = sum(_nbytes(t) for t in self._grad_vals()
                    + self._nograd_vals())
        state += sum(_nbytes(s) for st in self._opt_state for s in st)
        return MemoryAnalysis(state + self._batch_bytes, state + 4, state,
                              self._temp_bytes, self._peak_bytes)

    def lowered_stablehlo(self):
        """The reference returns its step's StableHLO, XLA's program text;
        a torch step has no counterpart."""
        raise MXNetError(
            "lowered_stablehlo: the port's step is eager torch, with no XLA "
            "program to print; read memory_analysis() for what remat "
            "changes, and the kernels' launch counters (ops.fused_bn."
            "launch_counts(), ops.fused_rnn.launch_counts()) for what "
            "the step ran")

    def _lr_sched_obj(self):
        """The stateful schedule driving this step's lr, if any."""
        for cand in (getattr(self, "_lr_schedule_base", None),
                     self._lr_schedule, self._opt.lr_scheduler):
            if cand is not None and hasattr(cand, "state_dict"):
                return cand
        return None

    def state_dict(self, device=False):
        """The resumable training state: the step count `t`, the
        parameters (`grad_vals`, `nograd_vals`), the optimizer state, the
        generators' states (`rng_key`, `random.get_state()`) and a
        stateful LR schedule's state (`lr_sched`, JSON as uint8). Host
        (numpy) copies, so a later step cannot change them; bfloat16
        values come as float32. `device=True` gives the live tensors
        instead, which the next step updates in place: copy what you keep
        before it. Optimizer state kept sharded over the mesh comes
        gathered whole in the host form (every rank of the mesh must call
        then), and in the live form as a `Shard`: this rank's block with
        where it lies in the whole tensor."""
        if self._plist is None:
            self._build()
        live = (tuple(self._grad_vals()), tuple(self._nograd_vals()),
                tuple(tuple(s) for s in self._opt_state))
        if device:
            live = live[:2] + (tuple(
                tuple(self._shard(lay, v, tuple(w.shape)) if sh else v
                      for v, sh in zip(st, shs))
                for st, shs, lay, w in zip(live[2], self._state_sharded,
                                           self._layouts,
                                           self._grad_vals())),)
        else:
            live = (tuple(_to_host(v) for v in live[0]),
                    tuple(_to_host(v) for v in live[1]),
                    tuple(tuple(_to_host(self._gather(lay, v) if sh else v)
                                for v, sh in zip(st, shs))
                          for st, shs, lay in zip(live[2],
                                                  self._state_sharded,
                                                  self._layouts)))
        out = {"t": np.int64(self._t), "grad_vals": live[0],
               "nograd_vals": live[1], "opt_state": live[2],
               "rng_key": _random.get_state()}
        sched = self._lr_sched_obj()
        if sched is not None:
            out["lr_sched"] = np.frombuffer(
                json.dumps(sched.state_dict()).encode(), np.uint8).copy()
        return out

    def load_state_dict(self, state):
        """Restore a `state_dict()` (either form) into this step's
        parameters and optimizer state; a count or shape that differs
        from the model's raises ValueError. Optimizer state kept sharded
        over the mesh is given whole, as the host form holds it: each rank
        keeps its block."""
        if self._plist is None:
            self._build()
        # a sharded entry stands for the whole tensor of its weight's shape
        whole = [[(torch.empty(w.shape, device="meta") if sh else v)
                  for v, sh in zip(st, shs)]
                 for st, shs, w in zip(self._opt_state, self._state_sharded,
                                       self._grad_vals())]
        tmpls = (("grad_vals", self._grad_vals()),
                 ("nograd_vals", self._nograd_vals()),
                 ("opt_state", [tuple(s) for s in whole]))
        for name, tmpl in tmpls:
            if len(state[name]) != len(tmpl):
                raise ValueError(
                    "checkpoint %s has %d entries but the model expects %d "
                    "— wrong or since-modified model" %
                    (name, len(state[name]), len(tmpl)))
            flat_t = _flatten(tmpl)
            flat_v = _flatten(state[name])
            if len(flat_t) != len(flat_v):
                raise ValueError(
                    "checkpoint %s has %d arrays but the model expects %d "
                    "— wrong or since-modified model"
                    % (name, len(flat_v), len(flat_t)))
            for t, v in zip(flat_t, flat_v):
                if tuple(np.shape(v)) != tuple(t.shape):
                    raise ValueError(
                        "checkpoint %s entry has shape %s but the model "
                        "expects %s — wrong model or a lossy resume"
                        % (name, tuple(np.shape(v)), tuple(t.shape)))
        self._t = int(state["t"])
        if "rng_key" in state:
            _random.set_state(state["rng_key"])
        if "lr_sched" in state:
            sched = self._lr_sched_obj()
            if sched is not None:
                sched.load_state_dict(json.loads(bytes(bytearray(
                    np.asarray(state["lr_sched"]).astype(np.uint8)))
                    .decode()))
        with torch.no_grad():
            for name, tmpl in tmpls[:2]:
                for t, v in zip(_flatten(tmpl), _flatten(state[name])):
                    t.copy_(_as_tensor(v).to(t.dtype))
            for st, tm, vs, lay in zip(self._opt_state, whole,
                                       state["opt_state"], self._layouts):
                for t, w, v in zip(st, tm, vs):
                    if isinstance(v, Shard):   # this rank's block already
                        t.copy_(v.data)
                        continue
                    v = _as_tensor(v).to(device=t.device, dtype=t.dtype)
                    t.copy_(self._local(lay, v) if w.device.type == "meta"
                            else v)

    def sync_params(self):
        """Nothing to do: the parameters are updated where they live, and
        a sharded update gathers them back every step (the reference
        keeps them in the compiled step until this call)."""


def _as_tensor(v):
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                           else v)


def _flatten(tree):
    """The tensors / arrays of a nest of tuples and lists, in order."""
    out = []
    for v in tree:
        if isinstance(v, (tuple, list)):
            out.extend(_flatten(v))
        else:
            out.append(v)
    return out
