"""INT8 post-training quantization (port of
`mxnet_tpu/contrib/quantization.py`).

`quantize_model` rewrites a float Symbol into an int8 inference graph at
the Python DAG level: each FullyConnected and Convolution node (unless
excluded) becomes quantize -> quantized op -> dequantize over the ops of
`ops/quantization.py`. Its weights (and biases) are quantized once per
variable, a weight shared by two quantized consumers included, and a
variable an fp32 node also reads keeps its float entry. Activation ranges
come from calibration over `calib_data` ('naive' min / max, or 'entropy',
the KL-optimal threshold of `_kl_optimal_threshold`) or, with
calib_mode 'none', from dynamic `min` / `max` nodes that reduce the
batch to 0-dim ranges. The quantized and range variables carry shape
hints, so `simple_bind` and Module bind the graph without an args dict.
Calibration runs the float graph on `ctx` (the current context by
default); the statistics are host numpy, as the reference's are.
"""
from __future__ import annotations

import numpy as np

from ..context import current_context
from ..ndarray import NDArray
from ..ops import registry as _registry
from ..symbol import Symbol, SymNode, Variable

QUANTIZABLE = {"FullyConnected", "Convolution"}


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _collect_layer_stats(sym, arg_params, aux_params, calib_data,
                         collect_names, num_calib_examples=None, ctx=None):
    """Run the float graph over the calibration batches: each requested
    internal output's min, max and |values|."""
    ctx = ctx or current_context()
    internals = sym.get_internals()
    outs = internals.list_outputs()
    wanted = [n for n in collect_names if n in outs]
    group = Symbol(sum((internals[n]._outputs for n in wanted), []))
    args = {k: NDArray(v._data, ctx=ctx) for k, v in arg_params.items()}
    aux = {k: NDArray(v._data, ctx=ctx) for k, v in aux_params.items()}
    stats = {n: {"min": np.inf, "max": -np.inf, "samples": []}
             for n in wanted}
    seen = 0
    calib_data.reset()
    for batch in calib_data:
        args["data"] = NDArray(batch.data[0]._data, ctx=ctx)
        exe = group.bind(ctx, args=args, grad_req="null",
                         aux_states=aux or None)
        exe.forward(is_train=False)
        for n, out in zip(wanted, exe.outputs):
            a = out.asnumpy()
            st = stats[n]
            st["min"] = min(st["min"], float(a.min()))
            st["max"] = max(st["max"], float(a.max()))
            st["samples"].append(np.abs(a).ravel())
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    return stats


def _smooth(d, eps=1e-4):
    """Lift a count vector's zeros by eps, taking the mass from its
    nonzero bins (a q zero where p > 0 would make KL infinite)."""
    zeros = d == 0
    n_zero, n_nonzero = int(zeros.sum()), int((~zeros).sum())
    if n_zero == 0 or n_nonzero == 0:
        return d
    take = eps * n_zero / n_nonzero
    if take >= d[~zeros].min():
        return d + eps * zeros  # tiny counts: just lift the zeros
    return d + eps * zeros - take * ~zeros


def _kl_optimal_threshold(samples, num_bins=2001, num_quantized_bins=255):
    """Entropy calibration: the |x| threshold minimizing the KL divergence
    between the float distribution and its int8 projection. p carries the
    clipped tail's mass in its edge bin; q is built from the unclipped
    slice only, so a threshold that clips real mass pays for it."""
    arr = np.concatenate(samples)
    amax = float(arr.max()) if arr.size else 1e-8
    if amax <= 0:
        return 1e-8
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, amax))
    best_kl, best_t = np.inf, amax
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, (num_bins - num_quantized_bins) // 64)):
        sliced = hist[:i].astype(np.float64)
        p = sliced.copy()
        p[-1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        factor = i / num_quantized_bins
        q = np.zeros(i)
        for j in range(num_quantized_bins):
            lo = int(j * factor)
            hi = max(int((j + 1) * factor), lo + 1)
            chunk = sliced[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        ps = _smooth(p)
        qs = _smooth(q)
        if qs.sum() == 0:  # all the mass beyond the slice: q is empty
            continue
        pn = ps / ps.sum()
        qn = qs / qs.sum()
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(
            pn[mask] / np.maximum(qn[mask], 1e-300))))
        if kl < best_kl:
            best_kl, best_t = kl, float(edges[i if i < len(edges) else -1])
    return max(best_t, 1e-8)


# ---------------------------------------------------------------------------
# graph rewrite
# ---------------------------------------------------------------------------

def _quantize_weight(arr):
    """(int8 values, -amax, amax) of a float parameter, on the host."""
    a = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
    amax = max(float(np.abs(a).max()), 1e-12)
    q = np.clip(np.rint(a * (127.0 / amax)), -127, 127).astype(np.int8)
    return q, -amax, amax


def quantize_model(sym, arg_params, aux_params=None,
                   data_names=("data",), label_names=("softmax_label",),
                   ctx=None, excluded_sym_names=(),
                   calib_mode="none", calib_data=None,
                   num_calib_examples=None, calib_layer=None,
                   quantized_dtype="int8", logger=None):
    """Rewrite the FullyConnected / Convolution nodes to int8 (parity:
    contrib.quantization.quantize_model). Returns (quantized symbol,
    quantized arg_params, aux_params)."""
    if quantized_dtype != "int8":
        raise ValueError("quantize_model: only int8 is supported, got %r"
                         % (quantized_dtype,))
    excluded = set(excluded_sym_names)

    # 1. calibrate the activation ranges at the quantizable nodes' inputs
    ranges = {}
    if calib_mode != "none":
        if calib_data is None:
            raise ValueError("calib_mode %r needs calib_data" % calib_mode)
        if calib_mode not in ("naive", "entropy"):
            raise ValueError("unknown calib_mode %s" % calib_mode)
        node_inputs = []
        for node in sym._topo():
            if node.op is not None and node.op.name in QUANTIZABLE and \
                    node.name not in excluded:
                inp_node, inp_idx = node.inputs[0]
                name = _output_name(inp_node, inp_idx)
                if calib_layer is not None and not calib_layer(name):
                    continue
                node_inputs.append(name)
        if logger is not None:
            logger.info("calibrating %d tensors (%s mode)",
                        len(node_inputs), calib_mode)
        stats = _collect_layer_stats(sym, arg_params, aux_params or {},
                                     calib_data, node_inputs,
                                     num_calib_examples, ctx=ctx)
        for n, st in stats.items():
            if calib_mode == "naive":
                ranges[n] = max(abs(st["min"]), abs(st["max"]), 1e-8)
            else:
                ranges[n] = _kl_optimal_threshold(st["samples"])

    # 2. rewrite the DAG bottom-up
    new_args = dict(arg_params)
    memo = {}
    qparam_cache = {}  # var name -> (int8 values, min, max), made once

    # variables an fp32 node reads keep their float entry even when a
    # quantized consumer shares them
    fp32_consumed = set()
    for node in sym._topo():
        if node.op is not None and (node.op.name not in QUANTIZABLE
                                    or node.name in excluded):
            for inp, _ in node.inputs:
                if inp.op is None:
                    fp32_consumed.add(inp.name)

    def quantize_param(pname):
        if pname not in qparam_cache:
            qv, vmin, vmax = _quantize_weight(new_args[pname])
            new_args[pname + "_quantized"] = NDArray(qv)
            if pname not in fp32_consumed:
                new_args.pop(pname, None)
            qparam_cache[pname] = (qv, vmin, vmax)
        return qparam_cache[pname]

    def quantized_var(pname):
        qv, vmin, vmax = quantize_param(pname)
        return [Variable(pname + "_quantized",
                         shape=tuple(qv.shape))._outputs[0],
                _const_var(pname + "_min", vmin, new_args),
                _const_var(pname + "_max", vmax, new_args)]

    def quantize_node(node, new_inputs):
        no_bias = bool(node.kwargs.get("no_bias", False)) or \
            len(node.inputs) <= 2
        qweight, wmin, wmax = quantized_var(node.inputs[1][0].name)
        bias = [] if no_bias else quantized_var(node.inputs[2][0].name)
        data_in = new_inputs[0]
        # the activation range: calibrated, else the batch's own
        iname = _output_name(*node.inputs[0])
        if iname in ranges:
            amax = ranges[iname]
            dmin = _const_var(node.name + "_calib_min", -amax, new_args)
            dmax = _const_var(node.name + "_calib_max", amax, new_args)
        else:
            dmin = (SymNode(_registry.get("min"), node.name + "_dyn_min",
                            [data_in], {}), 0)
            dmax = (SymNode(_registry.get("max"), node.name + "_dyn_max",
                            [data_in], {}), 0)
        qdata = SymNode(_registry.get("_contrib_quantize"),
                        node.name + "_quantize", [data_in, dmin, dmax], {})
        qkwargs = dict(node.kwargs)
        ins = [(qdata, 0), qweight, (qdata, 1), (qdata, 2), wmin, wmax]
        if no_bias:
            qkwargs["no_bias"] = True
        ins += bias  # (bias, min_bias, max_bias) trail
        qop = "_contrib_quantized_fully_connected" \
            if node.op.name == "FullyConnected" else \
            "_contrib_quantized_conv"
        qnode = SymNode(_registry.get(qop), node.name + "_quantized", ins,
                        qkwargs)
        return SymNode(_registry.get("_contrib_dequantize"),
                       node.name + "_dequantize",
                       [(qnode, 0), (qnode, 1), (qnode, 2)], {})

    def clone(node):
        if id(node) in memo:
            return memo[id(node)]
        new_inputs = [(clone(n), i) for n, i in node.inputs]
        if node.op is None:
            cloned = node  # variables are shared
        elif node.op.name in QUANTIZABLE and node.name not in excluded:
            cloned = quantize_node(node, new_inputs)
        else:
            cloned = SymNode(node.op, node.name, new_inputs,
                             dict(node.kwargs), attr=dict(node.attr))
        memo[id(node)] = cloned
        return cloned

    for node in sym._topo():  # bottom-up, so no deep recursion
        clone(node)
    new_outputs = [(memo[id(n)], i) for n, i in sym._outputs]
    return Symbol(new_outputs), new_args, dict(aux_params or {})


def _const_var(name, value, new_args):
    """A 0-dim parameter variable holding a range; shape () lets
    simple_bind infer it."""
    new_args[name] = NDArray(np.float32(value).reshape(()))
    return Variable(name, shape=())._outputs[0]


def _output_name(node, idx):
    if node.op is None:
        return node.name
    if node.num_outputs == 1:
        return node.name + "_output"
    return "%s_output%d" % (node.name, idx)
