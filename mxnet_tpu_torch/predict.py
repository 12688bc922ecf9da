"""Inference and deployment (port of `mxnet_tpu/predict.py`).

Parity: the reference's standalone predict ABI
(`include/mxnet/c_predict_api.h:78-200` — MXPredCreate from symbol JSON +
param bytes, SetInput/Forward/GetOutput/Reshape) and the amalgamation
single-artifact predict build.

`Predictor` binds a Symbol and its parameters to an inference executor.
`export_model` traces a model (a Symbol with its parameters, or an
initialized Gluon block) with `torch.export` (non-strict) into one
artifact, a zip of the reference's layout: `meta.json`, `signature.txt`
(the same dtype tokens) and `model.pt2`, which `torch.export.save` writes
and which takes the place of the reference's `model.stablehlo` /
`model.mlir`. The parameters travel as the exported program's state, not
as constants baked for one device. `load_exported` replays the artifact
through torch alone, on the device it is asked for: no symbol graph, op
registry or parameter file is read at serving time.

The one kernel an exported graph may hold is K4a, the fused-RNN forward,
registered as the torch.library op `mxnet_tpu_torch::rnn_fwd`
(`ops/fused_rnn.py`): `load_exported` imports that module before it loads
a program. K1-K3 launch through ctypes and sit on no inference path this
module takes (eval-mode BatchNorm composes, as the reference's does); a
graph that reaches one raises, naming it. The export is a compile at the
watchdog's site `predict.export` (`introspect.compile_region`, as the
reference's), the AOTInductor compile one at `predict.compile_for_cpp`.
Every entry point runs on the card unless the caller asks for the CPU
(`ctx=mx.cpu()`, or inside `with mx.cpu():`).

The C++ side (`cpp_package/`) runs AOTInductor packages:
`compile_for_cpp` adds one for a device to an artifact, and
`export_train_step` writes a `TrainStep` as the reference's training
artifact with the package of the step's device.
"""
from __future__ import annotations

import functools
import io
import json
import os
import shutil
import subprocess
import tempfile
import zipfile

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .ndarray import NDArray


def _load_param_payload(params, ctx=None):
    """{name: NDArray} from a dict of arrays, a .params path, or the raw
    file bytes (the c_predict_api contract is a byte buffer,
    c_predict_api.h:96), on `ctx`. Paths and bytes go through the one
    loader (bf16 tags, the legacy format, list/dict duality)."""
    from .utils import serialization
    if isinstance(params, dict):
        return {k: (v if isinstance(v, NDArray)
                    else NDArray(np.asarray(v), ctx=ctx))
                for k, v in params.items()}
    loaded = serialization.load_ndarrays(params, ctx=ctx)
    if isinstance(loaded, list):
        raise MXNetError("the .params payload carries no names — a "
                         "predictor needs named parameters")
    return loaded


def _split_arg_aux(payload):
    from .utils.serialization import split_arg_aux
    # bare keys (plain npz saves) serve as arg params at predict time
    return split_arg_aux(payload, unprefixed="arg")


def _context(ctx):
    from .context import current_context
    return ctx if ctx is not None else current_context()


class Predictor:
    """Parity: MXPredCreate/MXPredSetInput/MXPredForward/MXPredGetOutput.

    Usage:
        pred = Predictor(open("m-symbol.json").read(), "m-0001.params",
                         {"data": (1, 3, 224, 224)})
        pred.set_input("data", x)      # or forward(data=x)
        pred.forward()
        out = pred.get_output(0)
    """

    def __init__(self, symbol_json, params, input_shapes, ctx=None):
        from . import symbol as sym_mod
        sym = sym_mod.load_json(symbol_json) \
            if isinstance(symbol_json, str) else symbol_json
        self._sym = sym
        self._ctx = _context(ctx)
        arg_params, aux_params = _split_arg_aux(
            _load_param_payload(params, self._ctx))
        self._input_names = [n for n in sym.list_arguments()
                             if n not in arg_params]
        missing = set(input_shapes) - set(self._input_names)
        if missing:
            raise MXNetError("input_shapes name(s) %s are bound parameters "
                             "or unknown" % sorted(missing))
        self._arg_params = arg_params
        self._aux_params = aux_params
        self._bind(dict(input_shapes))

    def _bind(self, input_shapes):
        self._input_shapes = input_shapes
        kwargs = dict(input_shapes)
        kwargs.update({k: v.shape for k, v in self._arg_params.items()})
        self._exec = self._sym.simple_bind(ctx=self._ctx, grad_req="null",
                                           **kwargs)
        self._exec.copy_params_from(self._arg_params, self._aux_params,
                                    allow_extra_params=True)
        self._inputs = {}

    def reshape(self, input_shapes):
        """Parity: MXPredReshape — rebind for new input shapes."""
        self._bind(dict(input_shapes))

    def set_input(self, name, value):
        if name not in self._input_names:
            raise MXNetError("unknown input %s (inputs: %s)"
                             % (name, self._input_names))
        # the caller's dtype is kept: int inputs (token ids) must not
        # round-trip through float32
        self._inputs[name] = value.as_in_context(self._ctx) \
            if isinstance(value, NDArray) else \
            NDArray(np.asarray(value), ctx=self._ctx)

    def forward(self, **inputs):
        for n, v in inputs.items():
            self.set_input(n, v)
        self._exec.forward(is_train=False, **self._inputs)
        return self._exec.outputs

    def get_output(self, index=0):
        return self._exec.outputs[index]

    def predict(self, inputs):
        """Batch helper over the bound signature: see `batch_predict`."""
        if len(self._input_shapes) != 1:
            raise MXNetError("predict(list) helps single-input models; "
                             "this predictor has inputs %s"
                             % sorted(self._input_shapes))
        name, sig = next(iter(self._input_shapes.items()))
        return batch_predict(
            lambda x: self.forward(**{name: x})[0].asnumpy(), sig, inputs)


def batch_predict(forward, sig_shape, inputs):
    """Run a list of variable-length samples through a FIXED-shape
    forward: pad each sample to the signature (zeros), group into chunks
    of the signature batch, and trim outputs back per sample.

    `forward(x)` takes exactly `sig_shape` = (B, *rest) and returns one
    array (B, ...). Each sample may be shorter than `rest` along the
    FIRST feature axis (the ragged axis — token sequences); all other
    axes must match. Returns a list of per-sample outputs; when the
    output's axis 1 mirrors the padded ragged axis it is trimmed to the
    sample's true length, otherwise the row is returned whole. Any mix
    of lengths runs in ceil(len/B) fixed-shape calls."""
    B, rest = sig_shape[0], tuple(sig_shape[1:])
    arrs, lengths = [], []
    for i, s in enumerate(inputs):
        a = np.asarray(s)
        if a.shape == rest:
            arrs.append(a)
            lengths.append(rest[0] if rest else None)
            continue
        if not rest or a.ndim != len(rest) or a.shape[1:] != rest[1:] \
                or a.shape[0] > rest[0]:
            raise MXNetError(
                "sample %d shape %s doesn't fit signature %s (only the "
                "first feature axis may be shorter)"
                % (i, a.shape, (B,) + rest))
        pad = np.zeros(rest, a.dtype)
        pad[:a.shape[0]] = a
        arrs.append(pad)
        lengths.append(a.shape[0])
    outs = []
    for lo in range(0, len(arrs), B):
        chunk = arrs[lo:lo + B]
        batch = np.zeros((B,) + rest, chunk[0].dtype)
        for j, a in enumerate(chunk):
            batch[j] = a
        out = np.asarray(forward(batch))
        for j in range(len(chunk)):
            row = out[j]
            ln = lengths[lo + j]
            if ln is not None and row.ndim >= 1 and rest \
                    and row.shape[0] == rest[0]:
                row = row[:ln]
            outs.append(row)
    return outs


def quantize_lm_params(params, n_layers, mode="int8",
                       names=("wqkv", "wo", "w1", "w2")):
    """Quantize a transformer-LM parameter dict once at load:
    per-output-channel symmetric int8 for each layer's 2-D matmul
    weights, each becoming a `{"q": int8, "s": float32 per channel}` dict
    that `ops.quantization.maybe_quant_matmul` consumes. Embeddings, the
    positional table, layer norms and the LM head stay float (the final
    projection dominates the logit error), and so do 3-D MoE expert
    stacks. Returns a new dict; the caller keeps the float originals."""
    if str(mode) != "int8":
        raise MXNetError("weight quantization mode %r is not supported "
                         "(int8 or None)" % (mode,))
    from .ops.quantization import quantize_channelwise
    out = dict(params)
    for i in range(int(n_layers)):
        pre = "layer%d_" % i
        for name in names:
            w = out.get(pre + name)
            if w is None or getattr(w, "ndim", 0) != 2:
                continue
            q, s = quantize_channelwise(w, axis=1)
            out[pre + name] = {"q": q, "s": s}
    return out


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


class _SymbolProgram(torch.nn.Module):
    """A Symbol with its parameters as a module: the parameters are
    buffers (the exported program's state), the free inputs its
    arguments, and the graph runs through `Symbol._eval` in inference
    mode. An RNN's begin states that the payload lacks are zeros made
    from the data's shape and device, as the executor makes them."""

    def __init__(self, sym, input_names, values):
        super().__init__()
        self._sym = sym
        self._input_names = list(input_names)
        self._names = list(values)
        for i, name in enumerate(self._names):
            self.register_buffer("p%d" % i, values[name].detach())

    def forward(self, *xs):
        values = dict(zip(self._input_names, xs))
        values.update({n: getattr(self, "p%d" % i)
                       for i, n in enumerate(self._names)})
        with torch.no_grad():
            outs, _ = self._sym._eval(values, train=False,
                                      zero_missing_aux=True)
        return tuple(outs)


class _BlockProgram(torch.nn.Module):
    """A Gluon block as a module: each Gluon parameter's tensor is a
    buffer (the exported program's state), put back into the parameter
    for the length of a call, so the tracer's stand-ins for the buffers
    are what the block reads."""

    def __init__(self, block):
        super().__init__()
        self._block = block
        self._params = list(block.collect_params().values())
        for i, p in enumerate(self._params):
            self.register_buffer("p%d" % i, p.data()._data.detach())

    def forward(self, *xs):
        from . import autograd
        held = [p.data() for p in self._params]
        saved = [nd._data_buf for nd in held]
        try:
            for i, nd in enumerate(held):
                nd._data_buf = getattr(self, "p%d" % i)
            with autograd.pause(train_mode=False), torch.no_grad():
                out = self._block(*[NDArray(x) for x in xs])
        finally:
            for nd, t in zip(held, saved):
                nd._data_buf = t
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return tuple(o._data for o in outs)


def _symbol_program(model, params):
    """(module, input names, parameter device) of a Symbol + params."""
    arg_params, aux_params = _split_arg_aux(_load_param_payload(
        params or {}, None))
    input_names = [n for n in model.list_arguments()
                   if n not in arg_params]
    missing_aux = [n for n in model.list_auxiliary_states()
                   if n not in aux_params and not _rnn_state(model, n)]
    if missing_aux:
        raise MXNetError("params payload is missing auxiliary state(s) "
                         "%s — export needs the trained aux values "
                         "('aux:<name>' entries)" % missing_aux)
    values = {k: v._data for k, v in arg_params.items()}
    values.update({k: v._data for k, v in aux_params.items()
                   if k in model.list_auxiliary_states()})
    dev = next((t.device for t in values.values()), None)
    return _SymbolProgram(model, input_names, values), input_names, dev


def _rnn_state(sym, name):
    """Whether aux variable `name` is read only as an RNN's begin state
    (made as zeros when the payload lacks it)."""
    uses = [(node.op.name, pos) for node in sym._topo() if node.op
            for pos, (inp, _) in enumerate(node.inputs) if inp.name == name
            and inp.op is None]
    return bool(uses) and all(op == "RNN" and pos >= 2 for op, pos in uses)


def _sig_dtype(dt):
    """dtype -> the signature.txt token (the reference's C++ predictor
    reads these). Unsupported dtypes fail here, at export."""
    name = str(dt).replace("torch.", "")
    token = {"float32": "f32", "float16": "f16", "float64": "f64",
             "bfloat16": "bf16", "int32": "s32", "int64": "s64",
             "int8": "s8", "uint8": "u8", "bool": "pred"}.get(name)
    if token is None:
        raise MXNetError(
            "export_model: dtype %s has no C++ predictor mapping (supported:"
            " f32/f16/f64/bf16/s32/s64/s8/u8/bool)" % name)
    return token


def _sig_line(kind, t):
    return "%s %s %s" % (kind, _sig_dtype(t.dtype),
                         "x".join(str(int(d)) for d in t.shape))


def _program_outputs(ep):
    """The fake values of an exported program's user outputs."""
    user = set(ep.graph_signature.user_outputs)
    node = next(n for n in ep.graph.nodes if n.op == "output")
    return [o.meta["val"] for o in node.args[0]
            if o is not None and o.name in user]


def export_model(model, input_shapes, path, params=None,
                 input_dtypes=None):
    """Trace `model` (a Symbol with `params`, or an initialized Gluon
    block) with `torch.export` (strict=False) on the device its
    parameters lie on, and write the artifact to `path`: `meta.json`
    (the inputs' names, shapes and dtypes), `signature.txt` (one "in" /
    "out" line a tensor: dtype token and dims) and `model.pt2`. Returns
    `path`. Raises when the graph reaches a kernel that an exported
    program cannot hold (K1-K3), naming it."""
    from .symbol import Symbol
    shapes = list(input_shapes.items()) if isinstance(input_shapes, dict) \
        else list(input_shapes)
    dtypes = input_dtypes or {}
    if isinstance(model, Symbol):
        module, input_names, dev = _symbol_program(model, params)
        shape_map = dict(shapes)
        missing = [n for n in input_names if n not in shape_map]
        extra = [n for n in shape_map if n not in input_names]
        if missing or extra:
            raise MXNetError(
                "input_shapes must name exactly the free inputs %s "
                "(missing: %s, unknown: %s)" % (input_names, missing, extra))
        shapes = [(n, shape_map[n]) for n in input_names]
    else:
        params = list(model.collect_params().values())
        dev = next((p._data._data.device for p in params
                    if p._data is not None), None)
    if dev is None:
        dev = _context(None).torch_device()
    examples = tuple(torch.zeros(tuple(s), device=dev,
                                 dtype=torch_dtype(dtypes.get(n, "float32")))
                     for n, s in shapes)
    if not isinstance(model, Symbol):
        if any(p._deferred_init for p in params):
            # one eager call gives deferred parameters their shapes
            from . import autograd
            with autograd.pause(train_mode=False):
                model(*[NDArray(x) for x in examples])
        module = _BlockProgram(model)
    # the programs' forwards run under no_grad, where the ops switch no
    # grad mode: the graph holds no grad-mode region
    from .telemetry import introspect
    with introspect.compile_region("predict.export", phase="export",
                                   path=path), torch.no_grad():
        ep = torch.export.export(module, examples, strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    meta = {"inputs": [{"name": n, "shape": [int(d) for d in s],
                        "dtype": str(dtypes.get(n, "float32"))}
                       for n, s in shapes],
            "format": 1}
    sig = [_sig_line("in", x) for x in examples]
    sig += [_sig_line("out", o) for o in _program_outputs(ep)]
    _publish_zip(path, {"meta.json": json.dumps(meta).encode(),
                        "model.pt2": buf.getvalue(),
                        "signature.txt": ("\n".join(sig) + "\n").encode()})
    return path


class ExportedPredictor:
    """Serving-side wrapper over a loaded artifact: the same predict
    surface, with no framework graph machinery. `program` is the
    `torch.export.ExportedProgram` on `device`."""

    def __init__(self, program, meta, device):
        self.program = program
        self.device = device
        self._module = program.module()
        self._meta = meta
        self._input_names = [i["name"] for i in meta["inputs"]]
        self._inputs = {}
        self._outputs = None

    @property
    def input_descs(self):
        return self._meta["inputs"]

    def _tensor(self, value, dtype):
        t = value._data if isinstance(value, NDArray) else \
            torch.as_tensor(np.asarray(value))
        return t.to(device=self.device, dtype=torch_dtype(dtype))

    def set_input(self, name, value):
        if name not in self._input_names:
            raise MXNetError("unknown input %s" % name)
        desc = self._meta["inputs"][self._input_names.index(name)]
        self._inputs[name] = self._tensor(value, desc["dtype"])

    def _call(self, args):
        with torch.no_grad():
            return tuple(self._module(*args))

    def forward(self, **inputs):
        for n, v in inputs.items():
            self.set_input(n, v)
        unset = [n for n in self._input_names if n not in self._inputs]
        if unset:
            raise MXNetError("input(s) %s were never set" % unset)
        self._outputs = self._call([self._inputs[n]
                                    for n in self._input_names])
        return [NDArray(o) for o in self._outputs]

    def get_output(self, index=0):
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return NDArray(self._outputs[index])

    def predict(self, inputs):
        """Batch helper over the exported signature: see `batch_predict`.
        Variable-length samples pad into the artifact's fixed shape, and
        every call replays the one program."""
        if len(self._input_names) != 1:
            raise MXNetError("predict(list) helps single-input artifacts; "
                             "this one has inputs %s" % self._input_names)
        desc = self._meta["inputs"][0]

        def fwd(x):
            out = self._call([self._tensor(x, desc["dtype"])])[0]
            return out.detach().float().cpu().numpy()

        return batch_predict(fwd, tuple(desc["shape"]), inputs)


def load_exported(path, ctx=None):
    """Load an artifact that `export_model` wrote onto `ctx`'s device (the
    card by default), its state and any device its graph names moved
    there."""
    from .ops import fused_rnn  # noqa: F401 — registers rnn_fwd's op
    import torch.export.passes
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        blob = z.read("model.pt2")
    device = _context(ctx).torch_device()
    program = torch.export.load(io.BytesIO(blob))
    program = torch.export.passes.move_to_device_pass(program, device)
    return ExportedPredictor(program, meta, device)


# ---------------------------------------------------------------------------
# the C++ side (cpp_package/): AOTInductor packages and training artifacts
# ---------------------------------------------------------------------------


def _device_kind(device):
    """The artifact's package name of a torch device: "cuda" or "cpu"."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


@functools.lru_cache(maxsize=None)
def _inductor_cxx():
    """A C++ compiler for Inductor's AOT build: the first of $CXX, g++ on
    the PATH, /usr/bin/g++ and c++ that builds a shared object with
    -fopenmp (the package's wrapper is built so; a compiler without
    libgomp's spec file fails there), asked once a process."""
    tried = []
    for cxx in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
                shutil.which("c++")):
        if not cxx or cxx in tried or not os.path.exists(cxx):
            continue
        tried.append(cxx)
        with tempfile.TemporaryDirectory() as d:
            p = subprocess.run(
                [cxx, "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-",
                 "-o", os.path.join(d, "t.so")],
                input="int f() { return 0; }\n", capture_output=True,
                text=True)
        if p.returncode == 0:
            return cxx
    raise MXNetError("no C++ compiler builds with -fopenmp (tried %s); "
                     "AOTInductor needs one" % (tried,))


def _aoti_package(program, device, blob):
    """The bytes of the AOTInductor package of `program()` (a callable
    giving the ExportedProgram on `device`; `blob` is its
    `torch.export.save` bytes before the move), compiled with float32
    products in float32 (the port's parity rule). The compile is the watchdog's site
    `predict.compile_for_cpp`; with an AOT cache configured the package
    is looked up there first, keyed by the program's content and the
    device, and a hit compiles nothing and loads no program. For the card, Inductor's probe of
    the host's CPU vector ISAs is skipped (its host wrapper then builds
    without vector flags): each ISA, and each extension of one (bf16,
    VNNI, AMX), is a compile and a fresh Python process that loads it,
    which cost 20-40 s of a process's first compile on the card's host
    (tools/aoti_compile_probe.py; H100 80GB HBM3, 700 W). A CPU package keeps the probe, whose
    pick its kernels are compiled for."""
    from . import aot
    from .telemetry import introspect
    site = "predict.compile_for_cpp"

    def build():
        # Inductor is imported only when a package is compiled: its
        # import alone costs seconds, which a cache hit does not pay
        import contextlib
        from unittest import mock
        import torch._inductor
        import torch._inductor.cpu_vec_isa as vec_isa
        from .ops import fused_rnn  # noqa: F401 — K4a's op and its fake
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        no_probe = (mock.patch.object(vec_isa, "valid_vec_isa_list", list)
                    if torch.device(device).type == "cuda"
                    else contextlib.nullcontext())
        with tempfile.TemporaryDirectory() as d:
            pkg = os.path.join(d, "model.pt2")
            try:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                with introspect.compile_region(
                        site, phase="aoti", device=str(device)), \
                        torch._inductor.config.patch(
                            {"cpp.cxx": (_inductor_cxx(),)}), no_probe:
                    torch._inductor.aoti_compile_and_package(
                        program(), package_path=pkg)
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = flags
            with open(pkg, "rb") as f:
                return f.read()

    if aot.cache() is None:
        return build()
    key = aot.key_for(site, None, aot.program_digest(blob), variant="aoti",
                      placement=aot.placement_key((device,)))
    pkg, _hit = aot.fetch(
        site, key, "aoti", "model.pt2", build, phase="aoti",
        load=lambda payload: aot.load_executable(payload, "aoti",
                                                 "model.pt2"))
    return pkg


def _publish_zip(path, entries):
    """Write {name: bytes} as the STORE-only zip at `path` (the C++
    reader takes no compressed entry) by an atomic-rename publish: a
    reader, or a serving fleet booting off the artifact, never sees a
    half-written zip."""
    from .utils import atomic_publish
    with atomic_publish(str(path)) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
            for name, data in entries.items():
                z.writestr(name, data)


def compile_for_cpp(path, ctx=None):
    """Compile the artifact at `path` (from `export_model` or
    `export_train_step`) for the C++ predictor on `ctx`'s device (the
    card by default): its `model.pt2` moved to the device and compiled by
    AOTInductor into `aoti/<cuda|cpu>.pt2`, which is added to the zip (a
    package of that kind already there is replaced) and named in
    `meta.json`'s "aoti". Returns `path`.

    The counterpart of the reference's C++ `PJRT_Client_Compile`, moved
    to Python because Inductor compiles there; `export_model` itself
    compiles nothing. A graph holding K4a keeps it as the op
    `mxnet_tpu_torch::rnn_fwd`, which the C++ side's
    `libmxtpu_torch_ops.so` serves."""
    import torch.export.passes
    from .ops import fused_rnn  # noqa: F401 — registers rnn_fwd's op
    device = _context(ctx).torch_device()
    kind = _device_kind(device)
    with zipfile.ZipFile(path) as z:
        entries = {n: z.read(n) for n in z.namelist()}

    def program():
        ep = torch.export.load(io.BytesIO(entries["model.pt2"]))
        return torch.export.passes.move_to_device_pass(ep, device)

    entries["aoti/%s.pt2" % kind] = _aoti_package(program, device,
                                                  entries["model.pt2"])
    meta = json.loads(entries["meta.json"])
    meta.setdefault("aoti", {})[kind] = {"torch": torch.__version__}
    entries["meta.json"] = json.dumps(meta).encode()
    _publish_zip(path, entries)
    return path


def export_train_step(step, example_x, example_y, path):
    """Write a built `TrainStep` as a training artifact that the C++
    trainer (`mxtpu_train`) runs with no Python: the reference's contract
    (mxnet_tpu/predict.py export_train_step).

    The step (the training-mode forward and loss, the gradients of every
    parameter whose grad_req is not "null", the optimizer's rule, the
    running stats the forward wrote) is a pure function of its state,
    traced by make_fx (torch.export alone cannot trace through
    torch.autograd.grad), exported by torch.export and compiled by
    AOTInductor for the step's device. Inputs are [state..., x, y, seed,
    lr, t], outputs [loss, state...] (output 1+i feeds input i of the next
    step); the state is the gradient parameters, the others, then each
    optimizer state in parameter order. The graph's stochastic ops draw
    from the device's default generator, which `mxtpu_train` seeds with
    `seed` before each step; `seed` is not read inside the graph.

    The artifact: `signature.txt`, `train.txt` ("n_state K"),
    `state/<i>.bin` (the state's current values, raw little-endian),
    `meta.json` ("train": n_state, n_grad, n_nograd, n_opt), `model.pt2`
    and `aoti/<cuda|cpu>.pt2`. Raises for a mesh step, as the reference
    does, and when the step reaches a kernel that an exported graph
    cannot hold (K1-K3, K4b), naming it: export a BatchNorm net with
    MXNET_FUSED_BN_EPILOGUE=0, an RNN with MXNET_FUSED_RNN=0. Remat changes
    memory, not values, and is not traced; the guard's flag is not part
    of the contract."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from . import autograd
    from . import random as _random
    from .ops import _cuda
    from .parallel.functional import swap_param_buffers
    if step._mesh is not None:
        raise MXNetError("export_train_step: mesh-sharded TrainSteps are "
                         "not exportable to the single-device C++ trainer; "
                         "build the TrainStep without a mesh")
    if step._plist is None:
        step._build()
    plist, mask = step._plist, step._grad_mask
    opt = step._opt
    lens = [len(s) for s in step._opt_state]
    gvals, nvals = step._grad_vals(), step._nograd_vals()
    n_g, n_n, n_o = len(gvals), len(nvals), sum(lens)
    n_state = n_g + n_n + n_o
    dev = plist[0]._data._data.device
    cdtype = step._compute_dtype
    mixed = cdtype != torch.float32

    def compute(t):
        return t.to(cdtype) if mixed and t.is_floating_point() else t

    def pure(*flat):
        state, (x, y, _seed, lr, t) = flat[:n_state], flat[n_state:]
        g_in, n_in = state[:n_g], state[n_g:n_g + n_n]
        o_in = state[n_g + n_n:]
        leaves = [w.detach().requires_grad_(True) for w in g_in]
        merged, gi, ni = [], iter(leaves), iter(n_in)
        for m in mask:
            merged.append(compute(next(gi) if m else next(ni)))
        with swap_param_buffers(plist, merged) as injected, \
                autograd._RecordingStateScope(True, True), \
                torch.enable_grad(), _random.default_generator_scope():
            out = step._net.forward(NDArray(compute(x)))
            if mixed:
                out = NDArray(out._data.float())
            loss = torch.mean(step._loss(out, NDArray(y))._data.float())
            wrote = {i: p._data._data_buf for i, p in enumerate(plist)
                     if p._data._data_buf is not injected[i]}
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        new_g, new_o, k = [], [], 0
        for i, (w, g) in enumerate(zip(g_in, grads)):
            g = torch.zeros_like(w) if g is None else g
            g = g.to(w.dtype) * opt.rescale_grad
            if opt.clip_gradient is not None:
                g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
            w2, s2 = step._apply_rule(
                w, g, tuple(o_in[k:k + lens[i]]), lr * step._lr_mults[i],
                opt.wd * step._wd_mults[i], t, step._hyper)
            k += lens[i]
            new_g.append(w2.detach())
            new_o.extend(s2)
        new_n, ni = [], iter(n_in)
        for i, m in enumerate(mask):
            if not m:
                v = next(ni)
                new_n.append(wrote[i].detach().to(v.dtype) if i in wrote
                             else v)
        outs = [loss.detach()] + new_g + new_n + list(new_o)
        # a state passed through unchanged is a copy, not the input
        return tuple(o.clone() if any(o is s for s in state) else o
                     for o in outs)

    def as_tensor(v):
        return (v._data if isinstance(v, NDArray)
                else torch.as_tensor(np.asarray(v))).detach().to(dev)

    state0 = [v.detach().clone() for v in gvals + nvals] + \
        [v.detach().clone() for s in step._opt_state for v in s]
    example = state0 + [as_tensor(example_x), as_tensor(example_y),
                        torch.tensor(0, dtype=torch.int32, device=dev),
                        torch.tensor(float(step._lr()), device=dev),
                        torch.tensor(1, dtype=torch.int32, device=dev)]
    from .telemetry import introspect
    with introspect.compile_region("predict.export", phase="export",
                                   path=path, train_step=True):
        with _cuda.tracing_step():
            gm = make_fx(pure, tracing_mode="fake")(*example)
        program = torch.export.export(gm, tuple(example), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    sig = [_sig_line("in", v) for v in example]
    sig += [_sig_line("out", o) for o in _program_outputs(program)]
    kind = _device_kind(dev)
    meta = {"format": 1,
            "train": {"n_state": n_state, "n_grad": n_g, "n_nograd": n_n,
                      "n_opt": n_o},
            "aoti": {kind: {"torch": torch.__version__}}}
    entries = {"meta.json": json.dumps(meta).encode(),
               "model.pt2": buf.getvalue(),
               "signature.txt": ("\n".join(sig) + "\n").encode(),
               "train.txt": b"n_state %d\n" % n_state}
    for i, v in enumerate(state0):
        entries["state/%d.bin" % i] = v.cpu().contiguous().numpy().tobytes() \
            if v.dtype != torch.bfloat16 else \
            v.cpu().contiguous().view(torch.int16).numpy().tobytes()
    entries["aoti/%s.pt2" % kind] = _aoti_package(lambda: program, dev,
                                                  buf.getvalue())
    _publish_zip(path, entries)
    return path
