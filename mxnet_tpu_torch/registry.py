"""Class registries by nickname (port of `mxnet_tpu/registry.py`), as
the metric module registers its classes: `register`, `alias` and a
`create` that takes a name, a JSON `[name, kwargs]` string or an
instance."""
from __future__ import annotations

import json

_REGISTRIES = {}


def get_register_func(base_class, nickname):
    registry = _REGISTRIES.setdefault(nickname, {})

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            "can only register subclass of %s" % base_class.__name__
        registry[(name or klass.__name__).lower()] = klass
        return klass

    return register


def get_alias_func(base_class, nickname):
    registry = _REGISTRIES.setdefault(nickname, {})

    def alias(*aliases):
        def reg(klass):
            for a in aliases:
                registry[a.lower()] = klass
            return klass
        return reg

    return alias


def get_create_func(base_class, nickname):
    registry = _REGISTRIES.setdefault(nickname, {})

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            return args[0]
        if args and isinstance(args[0], str) and args[0].startswith("["):
            name, kw = json.loads(args[0])
            return registry[name.lower()](**kw)
        name = args[0] if args else kwargs.pop(nickname)
        args = args[1:]
        if name.lower() not in registry:
            raise ValueError("unknown %s %r: it is not registered (known: "
                             "%s)" % (nickname, name, sorted(registry)))
        return registry[name.lower()](*args, **kwargs)

    return create
