"""Extra op documentation for the imperative namespace (port of
`mxnet_tpu/ndarray_doc.py`). An op's docstring is its registry entry's
(`ops.registry.OpDef.doc`); `attach` replaces it with the docstring of
an `NDArrayDoc` subclass named `<op>Doc`, on the registry entry and on
`mx.nd.<op>`, and `_build_doc` composes a docstring from an op's
description and arguments."""
from .ops import registry as _registry


class NDArrayDoc:
    """Subclass as `<op>Doc` with a docstring to document `mx.nd.<op>`."""


def _build_doc(func_name, desc, arg_names, arg_types, *_, **__):
    """A numpydoc docstring: `desc`, then a Parameters section of
    `name : type` lines."""
    lines = [desc, "", "Parameters", "----------"]
    for n, t in zip(arg_names, arg_types):
        lines.append("%s : %s" % (n, t))
    return "\n".join(lines)


def attach(cls=None):
    """Give each registered op named by a `<op>Doc` subclass of `cls`
    (NDArrayDoc by default) that subclass's docstring; other names are
    skipped."""
    from . import ndarray as nd
    for sub in (cls or NDArrayDoc).__subclasses__():
        name = sub.__name__[:-3]  # strip "Doc"
        try:
            _registry.get(name).doc = sub.__doc__
        except KeyError:
            continue
        fn = getattr(nd, name, None)
        if callable(fn):
            fn.__doc__ = sub.__doc__
