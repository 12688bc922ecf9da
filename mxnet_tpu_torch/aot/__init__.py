"""mxnet_tpu_torch.aot — the persistent ahead-of-time cache (port of
`mxnet_tpu/aot/`).

What a fresh port process compiles is its kernel libraries (nvcc, in
`ops/_cuda.py`) and its AOTInductor packages (`predict.compile_for_cpp`,
`export_train_step`); this cache keeps both on disk, content-addressed,
so a restarted server, a respawned replica or a fresh C++ deployment
loads them with zero compiles. See cache.py for the key and the entry
layout.
"""
from .cache import (AOTCache, CorruptEntry, atomic_publish, cache,
                    cache_dir, configure, fetch, fingerprint, key_for,
                    load_executable, placement_key, program_digest,
                    serialize_executable_blob)

__all__ = [
    "AOTCache", "CorruptEntry", "atomic_publish", "cache", "cache_dir",
    "configure", "fetch", "fingerprint", "key_for", "load_executable",
    "placement_key", "program_digest", "serialize_executable_blob",
]
