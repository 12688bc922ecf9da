"""Model summaries and graph plots (port of `mxnet_tpu/visualization.py`).

`print_summary` prints a Symbol's layer table (name and op, output shape,
parameter count, the op nodes feeding it) with the reference's columns
and rounding; `plot_network` gives its graph as a graphviz `Digraph`
(the `graphviz` package, imported when called); `block_summary` prints
the table `Block.summary` prints.
"""
from __future__ import annotations

import math

from .base import MXNetError


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64,
                                                                  .74, 1.)):
    """Print the layer table of `symbol`; with `shape` ({input: shape})
    each row gets its output shape and parameter count (the elements of
    its parameter inputs). Returns the total parameter count."""
    if shape is None:
        shape = {}
    show_shape = bool(shape)
    out_shapes = {}
    known_shapes = {}
    if show_shape:
        internals = symbol.get_internals()
        _, out_shapes_list, _ = internals.infer_shape(**shape)
        out_shapes = dict(zip(internals.list_outputs(), out_shapes_list))
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        known_shapes.update(zip(symbol.list_arguments(), arg_shapes))
        known_shapes.update(zip(symbol.list_auxiliary_states(), aux_shapes))
    positions = [int(line_length * p) for p in positions]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(["Layer (type)", "Output Shape", "Param #", "Previous Layer"],
              positions)
    print("=" * line_length)
    total_params = 0
    for node in symbol._topo():
        if node.op is None:
            continue
        cur_param = 0
        for inp, _ in node.inputs:
            if inp.op is None and inp.name not in shape and \
                    known_shapes.get(inp.name):
                cur_param += math.prod(known_shapes[inp.name])
        out_shape = out_shapes.get(node.name + "_output", out_shapes.get(
            node.name + "_output0", ""))
        pred = ",".join(i.name for i, _ in node.inputs if i.op is not None)
        print_row(["%s (%s)" % (node.name, node.op.name), str(out_shape),
                   cur_param, pred], positions)
        total_params += cur_param
    print("=" * line_length)
    print("Total params: %d" % total_params)
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """A graphviz Digraph of `symbol`: a box for each op node (op and
    name) and for each input variable (only `data` when hide_weights),
    and an edge from each shown input to the node it feeds. Raises
    MXNetError without the graphviz package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires the graphviz python package")
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs or {})
    dot = Digraph(name=title, format=save_format)
    conf = symbol._topo()
    for node in conf:
        if node.op is None:
            if hide_weights and node.name != "data":
                continue
            dot.node(name=node.name, label=node.name,
                     **dict(node_attr, fillcolor="#8dd3c7"))
        else:
            dot.node(name=node.name,
                     label="%s\n%s" % (node.op.name, node.name),
                     **dict(node_attr, fillcolor="#80b1d3"))
    names = {n.name for n in conf
             if n.op is not None or not hide_weights or n.name == "data"}
    for node in conf:
        if node.op is None:
            continue
        for inp, _ in node.inputs:
            if inp.name in names:
                dot.edge(tail_name=inp.name, head_name=node.name)
    return dot


def block_summary(block, *inputs):
    """Run `block(*inputs)` with a forward hook on every block of the tree
    and print one row a call (name, type, output shapes, parameter count of
    the block's own fully-shaped parameters), then the total; returns the
    total."""
    rows = []
    hooks = []

    def add_hook(b):
        def hook(blk, inp, out):
            nparams = sum(math.prod(p.shape)
                          for p in blk._reg_params.values()
                          if p.shape and all(s > 0 for s in p.shape))
            outs = out if isinstance(out, (list, tuple)) else [out]
            rows.append((blk.name, type(blk).__name__,
                         [tuple(o.shape) for o in outs
                          if hasattr(o, "shape")], nparams))
        hooks.append((b, b.register_forward_hook(hook)))

    block.apply(add_hook)
    try:
        block(*inputs)
    finally:
        for b, h in hooks:
            b._forward_hooks.pop(h, None)
    print("%-30s %-20s %-30s %12s" % ("Layer", "Type", "Output Shape",
                                      "Params"))
    print("=" * 96)
    total = 0
    for name, typ, shapes, nparams in rows:
        print("%-30s %-20s %-30s %12d" % (name, typ, str(shapes), nparams))
        total += nparams
    print("=" * 96)
    print("Total params: %d" % total)
    return total
