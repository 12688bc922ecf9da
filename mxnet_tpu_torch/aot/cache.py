"""The persistent AOT cache (port of `mxnet_tpu/aot/cache.py`).

The reference serializes XLA executables. What a fresh port process
compiles is two kinds of entry, and the cache keeps both:

  * **kernel libraries** — the nvcc builds of `ops/csrc/*.cu`
    (`ops/_cuda.library`, watchdog site `kernels.<stem>`); an entry's
    content is the source bytes and the nvcc flags, as `ops/_cuda.target`
    names its build;
  * **AOTInductor packages** — `predict._aoti_package` (through
    `compile_for_cpp` and `export_train_step`, site
    `predict.compile_for_cpp`); an entry's content is the serialized
    `ExportedProgram` (each member of its zip but the serialization id)
    and the device it was compiled for.

An entry is published to a disk directory under a content hash of
everything that determines it:

  * the environment **fingerprint**: torch and CUDA versions, the nvcc
    version where one is used, the device's name, capability and count,
    the C++ compiler Inductor picks (`predict._inductor_cxx`), the nvcc
    flags and the environment variables that change what is built;
  * the watchdog **site** and the entry's **variant** / signature;
  * the **placement**: the devices the entry was built for;
  * the sha256 of the **content** above.

The kernel switches (`MXNET_FUSED_RNN`, `MXNET_FUSED_BN_EPILOGUE`,
`MXNET_FLASH_ATTENTION`, `MXNET_PAGED_ATTENTION`) are not part of the
fingerprint: they pick which kernel runs, not what a library holds, and
an exported program already holds K4a's op or not in its content.

Entries are single zip files (`meta.json`, `payload.bin`, `trees.pkl`:
the reference's layout) published by atomic rename (first writer wins, a
racing loser discards its temp file), with sha256 digests over the
payload verified on every load. A corrupt, truncated or stale entry is
NEVER an error: the loader quarantines it and the caller compiles again
— the cache switches where a library or package comes from, never what
it computes.

Surface: `MXNET_AOT_CACHE_DIR`, `configure(path)` (what
`Engine(aot_cache=...)` and `serve(aot_cache=...)` call), `fetch` (the
one load-or-build seam both kinds go through) and `AOTCache.verify()`.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import pickle
import subprocess
import threading
import time
import zipfile

from ..base import MXNetError
from ..utils import atomic_publish

#: entry format version — bumped on any layout change (old entries then
#: fail the meta check and are rebuilt, never misread)
FORMAT = 1

#: entry file suffix (one zip per entry)
SUFFIX = ".mxaot"

#: env vars that change what nvcc or Inductor is asked to build
_FLAG_ENV = ("CXX", "CUDA_HOME", "TORCH_CUDA_ARCH_LIST",
             "TORCHINDUCTOR_MAX_AUTOTUNE", "TORCHINDUCTOR_FREEZING")


class CorruptEntry(MXNetError):
    """A cache entry failed its sha256 / format verification (truncated
    write, bit flip, stale layout). The loader quarantines the file and
    the caller compiles again — corruption costs a compile, never an
    error or a wrong library."""


@functools.lru_cache(maxsize=None)
def _nvcc_version():
    """nvcc's version line, or None without the CUDA toolkit."""
    try:
        from torch.utils.cpp_extension import CUDA_HOME
    except Exception:                                    # pragma: no cover
        return None
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        return None
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except Exception:                                    # pragma: no cover
        return "?"
    lines = [l for l in out.splitlines() if l.strip()]
    return lines[-1] if lines else "?"


@functools.lru_cache(maxsize=None)
def _device_fp():
    import torch
    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_kind": "cpu", "capability": None,
                "device_count": 0}
    cap = torch.cuda.get_device_capability(0)
    return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(0),
            "capability": "%d.%d" % cap,
            "device_count": torch.cuda.device_count()}


@functools.lru_cache(maxsize=None)
def _cxx():
    try:
        from ..predict import _inductor_cxx
        return _inductor_cxx()
    except Exception:
        return None


def fingerprint():
    """The environment part of every cache key: anything here changing
    invalidates the whole cache (by missing, not by erroring)."""
    import torch
    from ..libinfo import __version__ as fw
    from ..ops._cuda import NVCC_FLAGS
    fp = {"torch": torch.__version__, "cuda": torch.version.cuda,
          "framework": fw, "nvcc": _nvcc_version(), "cxx": _cxx(),
          "nvcc_flags": " ".join(NVCC_FLAGS)}
    fp.update(_device_fp())
    fp["env"] = {k: os.environ.get(k, "") for k in _FLAG_ENV}
    return fp


def placement_key(args):
    """Sorted device names the call's tensor arguments live on (lists,
    tuples and dicts walked; strings and torch devices taken as device
    names). A call with none keys on the current CUDA device, or "cpu"
    without one: what an entry was built for is part of its identity."""
    import torch
    names = set()

    def walk(a):
        if isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)
        elif isinstance(a, (str, torch.device)):
            names.add(str(torch.device(a)))
        else:
            dev = getattr(getattr(a, "_data", a), "device", None)
            if dev is not None:
                names.add(str(dev))
    walk(args)
    if not names:
        names = {"cuda:%d" % torch.cuda.current_device()
                 if torch.cuda.is_available() else "cpu"}
    return tuple(sorted(names))


def key_for(site, sig, content, variant=None, placement=(), fp=None):
    """The content-hash key of one entry. Any component changing —
    version, device, signature, flags, the content itself — produces a
    different key, so staleness is structurally a MISS. `content` is
    bytes or text."""
    fp = fingerprint() if fp is None else fp
    if isinstance(content, str):
        content = content.encode()
    h = hashlib.sha256()
    h.update(json.dumps(fp, sort_keys=True).encode())
    h.update(b"\x00site:" + site.encode())
    h.update(b"\x00variant:" + repr(variant).encode())
    h.update(b"\x00placement:" + repr(tuple(placement)).encode())
    h.update(b"\x00sig:" + repr(sig).encode())
    h.update(b"\x00content:")
    h.update(hashlib.sha256(content).digest())
    return h.hexdigest()[:40]


def program_digest(blob):
    """sha256 over a `torch.export.save` zip's members (name and bytes,
    in name order), the serialization id left out: two saves of one
    program differ at most there."""
    h = hashlib.sha256()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        for name in sorted(z.namelist()):
            if name.endswith("serialization_id"):
                continue
            h.update(name.encode() + b"\x00")
            h.update(hashlib.sha256(z.read(name)).digest())
    return h.digest()


# ---------------------------------------------------------------------------
# entry (de)serialization — the pair the cache stores and loads through
# ---------------------------------------------------------------------------


def serialize_executable_blob(payload, kind, name):
    """(payload bytes, pickled descriptor) of one entry: `kind` is
    "library" (a kernel library's shared object) or "aoti" (an
    AOTInductor package), `name` what it was built from."""
    if kind not in ("library", "aoti"):
        raise MXNetError("unknown AOT entry kind %r" % (kind,))
    return bytes(payload), pickle.dumps((kind, name))


def load_executable(payload, kind, name, path=None):
    """Rehydrate a stored entry: a library is written to `path` (atomic
    rename) and loaded with ctypes, returning the CDLL; an AOTInductor
    package is checked to be a readable zip and returned as bytes. Any
    failure raises (the caller quarantines the entry and compiles)."""
    if kind == "library":
        import ctypes
        if path is None:
            raise MXNetError("a library entry needs a path to load from")
        with atomic_publish(path) as tmp:
            with open(tmp, "wb") as f:
                f.write(payload)
        return ctypes.CDLL(path)
    if kind == "aoti":
        with zipfile.ZipFile(io.BytesIO(payload)) as z:
            if z.testzip() is not None:
                raise CorruptEntry("AOTInductor package %s is damaged"
                                   % name)
        return payload
    raise CorruptEntry("unknown AOT entry kind %r" % (kind,))


# ---------------------------------------------------------------------------
# the on-disk cache
# ---------------------------------------------------------------------------


class AOTCache:
    """One cache directory: load / store / verify over `.mxaot` entry
    zips. Thread- and process-safe by construction — every publish is an
    atomic rename and every load verifies digests, so concurrent writers
    and readers need no locks."""

    def __init__(self, path):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)

    def entry_path(self, site_sane, key):
        return os.path.join(self.path, "%s-%s%s" % (site_sane, key,
                                                    SUFFIX))

    # -- store ---------------------------------------------------------------

    def store(self, site_sane, key, payload, trees, extra=None):
        """Publish one entry. First writer wins: if the entry already
        exists (another replica/process got there first) nothing is
        written and False is returned."""
        final = self.entry_path(site_sane, key)
        if os.path.exists(final):
            return False
        meta = {"format": FORMAT, "key": key, "site": site_sane,
                "payload_sha256": hashlib.sha256(payload).hexdigest(),
                "trees_sha256": hashlib.sha256(trees).hexdigest(),
                "created": time.time()}
        if extra:
            meta.update(extra)
        tmp = "%s.tmp.%d.%x" % (final, os.getpid(),
                                threading.get_ident())
        try:
            with zipfile.ZipFile(tmp, "w") as z:
                z.writestr("meta.json", json.dumps(meta))
                z.writestr("payload.bin", payload)
                z.writestr("trees.pkl", trees)
            if os.path.exists(final):        # lost the race mid-write
                return False
            os.replace(tmp, final)
            return True
        finally:
            with contextlib.suppress(OSError):
                os.remove(tmp)

    # -- load ----------------------------------------------------------------

    def load(self, site_sane, key):
        """(payload, kind, name, meta) for a verified entry, None on a
        miss, CorruptEntry (after quarantining the file) on any
        verification failure — the caller compiles either way."""
        path = self.entry_path(site_sane, key)
        if not os.path.exists(path):
            return None
        try:
            with zipfile.ZipFile(path) as z:
                meta = json.loads(z.read("meta.json"))
                payload = z.read("payload.bin")
                trees = z.read("trees.pkl")
        except Exception as e:
            self._quarantine(path)
            raise CorruptEntry("unreadable cache entry %s: %s"
                               % (os.path.basename(path), e))
        if meta.get("format") != FORMAT \
                or meta.get("payload_sha256") \
                != hashlib.sha256(payload).hexdigest() \
                or meta.get("trees_sha256") \
                != hashlib.sha256(trees).hexdigest():
            self._quarantine(path)
            raise CorruptEntry("cache entry %s failed sha256/format "
                               "verification" % os.path.basename(path))
        try:
            kind, name = pickle.loads(trees)
        except Exception as e:
            self._quarantine(path)
            raise CorruptEntry("cache entry %s has an undecodable "
                               "descriptor: %s" % (os.path.basename(path),
                                                   e))
        return payload, kind, name, meta

    def invalidate(self, site_sane, key):
        """Quarantine one entry whose payload verified but failed to load
        (a hash-valid but unusable vintage)."""
        self._quarantine(self.entry_path(site_sane, key))

    def _quarantine(self, path):
        with contextlib.suppress(OSError):
            os.remove(path)

    # -- inventory -----------------------------------------------------------

    def entries(self):
        """Sorted entry file names currently published."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        return sorted(n for n in names if n.endswith(SUFFIX))

    def verify(self):
        """Non-destructive re-hash of every entry: (ok names, corrupt
        names)."""
        ok, bad = [], []
        for name in self.entries():
            path = os.path.join(self.path, name)
            try:
                with zipfile.ZipFile(path) as z:
                    meta = json.loads(z.read("meta.json"))
                    payload = z.read("payload.bin")
                    trees = z.read("trees.pkl")
                good = (meta.get("format") == FORMAT
                        and meta.get("payload_sha256")
                        == hashlib.sha256(payload).hexdigest()
                        and meta.get("trees_sha256")
                        == hashlib.sha256(trees).hexdigest())
            except Exception:
                good = False
            (ok if good else bad).append(name)
        return ok, bad


# ---------------------------------------------------------------------------
# process-wide configuration: configure() override > MXNET_AOT_CACHE_DIR
# ---------------------------------------------------------------------------

_ENV = object()          # sentinel: defer to the env var
_override = _ENV
_cache_lock = threading.Lock()
_caches = {}             # dir -> AOTCache (memoized: makedirs once)


def configure(path=_ENV):
    """Set the process-wide cache directory (`Engine(aot_cache=...)` /
    `serve(aot_cache=...)` land here). `None` disables caching whatever
    the env var says; calling with no argument restores env-var control
    (MXNET_AOT_CACHE_DIR)."""
    global _override
    _override = str(path) if path not in (None, _ENV) else path


def cache_dir():
    """The resolved cache directory, or None when caching is off."""
    if _override is not _ENV:
        return _override
    return os.environ.get("MXNET_AOT_CACHE_DIR") or None


def cache():
    """The process-wide AOTCache, or None when caching is off."""
    d = cache_dir()
    if not d:
        return None
    with _cache_lock:
        c = _caches.get(d)
        if c is None:
            try:
                c = _caches[d] = AOTCache(d)
            except OSError:
                return None
        return c


def fetch(site, key, kind, name, build, load=None, phase=None):
    """The one load-or-build seam: the entry at (`site`, `key`) from the
    process cache when it holds a verified one that `load(payload)`
    accepts (a warm load at `site`, counted on the watchdog and this
    thread), else `build()`'s bytes, published to the cache. Returns
    (what `load` returned or the payload, whether it was a hit). Without a
    cache this is `build()` alone. `build` records its own compile."""
    from ..telemetry import introspect
    c = cache()
    if c is None:
        return build(), False
    wd = introspect.watchdog()
    s = wd.site(site)
    t0 = time.perf_counter()
    try:
        rec = c.load(s.sane, key)
    except CorruptEntry:
        wd.record_cache_corrupt(s)
        rec = None
    if rec is not None:
        payload, rkind, rname, _meta = rec
        try:
            if rkind != kind:
                raise CorruptEntry("entry kind %r, expected %r"
                                   % (rkind, kind))
            out = load(payload) if load is not None else payload
        except Exception:
            c.invalidate(s.sane, key)
            wd.record_cache_corrupt(s)
        else:
            introspect.record_warm_load(site, time.perf_counter() - t0,
                                        phase=phase)
            return out, True
    wd.record_cache_miss(s)
    payload = build()
    try:
        blob, trees = serialize_executable_blob(payload, kind, name)
        if c.store(s.sane, key, blob, trees,
                   extra={"watchdog_site": site, "name": name}):
            wd.record_cache_store(s)
    except OSError:
        # persistence never breaks the path: an unwritable cache just
        # leaves the entry process-local
        pass
    return (load(payload) if load is not None else payload), False
