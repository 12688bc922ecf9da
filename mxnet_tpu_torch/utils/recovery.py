"""Failure recovery: asynchronous checkpointing with automatic resume
(port of `mxnet_tpu/utils/recovery.py`; the same file names, npz entry
names, manifest fields and `format: "sharded"`, so a checkpoint written
by one package restores in the other).

`CheckpointManager` keeps a directory of `ckpt-<step>.npz` files:

  * async saves — `save()` copies every leaf to host memory before it
    returns (a blocking device-to-host copy: the next train step updates
    the parameters and the optimizer state in place), and a writer
    thread, which touches only numpy, writes, fsyncs and publishes;
  * atomic publication — write to a temp file, `os.replace`, then fsync
    the directory so the rename itself is durable;
  * integrity manifest — a `ckpt-<step>.manifest.json` sidecar with the
    npz's size, sha256 and entry names; `restore()` verifies it first and
    `restore_latest()` falls back to the previous intact step;
  * retention — the newest `keep` steps stay, older ones are pruned;
  * single writer — in a world of several ranks holding the same
    replicated state only rank 0 writes; `wait()` is the BARRIER POINT
    (every rank calls it at the same program point: the writer blocks
    until its checkpoint published, then the world synchronizes);
  * per-rank SHARDED checkpoints — when the tree holds optimizer state
    kept sharded over the mesh (`parallel.trainer.Shard` leaves, which
    `TrainStep.state_dict(device=True)` hands out under ZeRO), EVERY rank
    writes `ckpt-<step>.shard<i>of<n>.npz` with the blocks it owns (each
    distinct block once; replicated leaves round-robin across ranks) and
    a self-certifying manifest beside it; rank 0 also publishes the
    global `ckpt-<step>.manifest.json` (format, rank count, mesh axes,
    every array's global shape / dtype / spec, the shard-file roster).
    `restore()` reassembles the global arrays from whichever files cover
    them, so a relaunch onto another world size resumes (elastic). The
    mode is chosen a save (a tree with `Shard` leaves must shard);
    `sharded=True/False` forces it, and `process_index` /
    `process_count` may be set to EMULATE several hosts from processes
    that each run a world of one (the drills' emulated pod).

The world comes from `parallel.mesh.world_info()`; the allgathers of the
multi-rank paths go through `torch.distributed.all_gather_object`.

Fault injection: `utils.chaos` fires inside the writer when armed (kill
mid-save before publication, corrupt a published file).
"""
from __future__ import annotations

import collections
import hashlib
import io
import json
import os
import re
import threading
import time as _time
import warnings
import zipfile

import numpy as np

from . import chaos as _chaos
from .. import telemetry

#: the errors a corrupt or incomplete checkpoint raises while it is read
_CORRUPT = (OSError, ValueError, zipfile.BadZipFile, EOFError, KeyError)


def _ckpt_metrics():
    """The checkpoint IO instruments, on the process-global registry
    (idempotent creation — every manager shares them)."""
    reg = telemetry.default_registry()
    return {
        "save_s": reg.histogram(
            "checkpoint_save_seconds",
            help="checkpoint write + atomic publish, per save"),
        "restore_s": reg.histogram(
            "checkpoint_restore_seconds",
            help="checkpoint verify + deserialize, per restore"),
        "bytes": reg.gauge(
            "checkpoint_bytes_per_host",
            help="bytes THIS host wrote for the last checkpoint "
                 "(sharded: only the shards it owns)"),
        "saves": reg.counter("checkpoint_saves_total",
                             help="checkpoints published by this host"),
        "restores": reg.counter("checkpoint_restores_total",
                                help="checkpoints restored"),
        "retries": reg.counter(
            "checkpoint_io_retries_total", flight=True,
            help="transient publish-IO failures retried with backoff"),
        "manifest_failures": reg.counter(
            "checkpoint_manifest_failures_total", flight=True,
            help="checkpoints skipped because manifest/shard "
                 "verification failed (corrupt or incomplete)"),
    }


_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")
_SHARD_RE = re.compile(r"^ckpt-(\d+)\.shard(\d+)of(\d+)\.npz$")


def _fsync_dir(path):
    """fsync a directory so a just-published rename survives power loss
    (best effort where directories cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _world():
    """(rank, world size, whether a process group of several ranks is
    up)."""
    from ..parallel.mesh import world_info
    w = world_info()
    return w["rank"], w["world_size"], w["world_size"] > 1


def _is_shard(v):
    return hasattr(v, "holders") and hasattr(v, "index") and \
        hasattr(v, "data")


def _host(v):
    """A numpy copy of a leaf that no later step can change. A tensor's
    device-to-host copy is a blocking one; bfloat16 (which numpy lacks)
    comes as float32; an ndarray that owns its memory passes through."""
    import torch
    if isinstance(v, torch.Tensor):
        t = v.detach()
        on_cpu = t.device.type == "cpu"
        if t.dtype == torch.bfloat16:
            t, on_cpu = t.float(), False
        a = t.cpu().numpy()
        return a.copy() if on_cpu else a
    if isinstance(v, np.ndarray) and v.base is None:
        return v
    return np.array(v)


def _dtype_name(v):
    import torch
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return "float32"
        return str(torch.empty((), dtype=v.dtype).numpy().dtype)
    return str(np.asarray(v).dtype)


class CheckpointManager:
    """Directory of ckpt-<step>.npz files with async atomic writes.

        mgr = CheckpointManager(dir, keep=3)
        mgr.save(step.t, train_step.state_dict())
        # after a crash or a preemption, the relaunched process:
        state = mgr.restore_latest()
        if state is not None:
            step0, tree = state
            train_step.load_state_dict(tree)
    """

    def __init__(self, directory, keep=3, async_save=True,
                 process_index=None, process_count=None, sharded=None):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._process_index = process_index
        self._process_count = process_count
        #: True = always shard, False = always single-writer, None = auto
        #: (shard iff the saved tree holds `Shard` leaves)
        self._sharded = sharded
        #: bounded-backoff attempts for each filesystem publish operation
        self.io_retries = 3
        #: optional () -> seconds-or-None deadline for the publish-IO
        #: retry backoff (ResilientLoop points it at its watcher's
        #: `remaining_grace()`, so a drain's retries never outlast the
        #: grace window)
        self.deadline_fn = None
        #: optional observers for the remediation supervisor: `on_error
        #: (exc)` when a publish finally failed, `on_success()` after a
        #: clean publish; best effort, never raised into the writer
        self.on_error = None
        self.on_success = None
        self._worker = None
        self._lock = threading.Lock()
        self._error = None
        self._metrics = _ckpt_metrics()
        #: the newest saves' timings: {"step", "copy_s" (the caller's
        #: host copies), "write_s" (the writer's write + fsync + publish,
        #: None until it finished)}
        self.save_log = collections.deque(maxlen=64)
        if self.is_writer or sharded:
            os.makedirs(directory, exist_ok=True)

    @property
    def process_index(self):
        if self._process_index is None:
            self._process_index = _world()[0]
        return self._process_index

    @property
    def process_count(self):
        if self._process_count is None:
            self._process_count = _world()[1]
        return self._process_count

    @property
    def is_writer(self):
        """Single-writer protocol: only rank 0 writes replicated state.
        In sharded mode every rank writes its own shard file; rank 0
        also owns the global manifest."""
        return self.process_index == 0

    # -- save ---------------------------------------------------------------
    def _resolve_sharded(self, flat):
        if self._sharded is not None:
            return bool(self._sharded)
        return any(_is_shard(v) for v in flat.values())

    def save(self, step, tree, block=False):
        """Snapshot `tree` (a nest of dicts / lists / tuples of arrays or
        tensors) at `step`. The host copies happen here; the file IO runs
        on a writer thread unless async_save=False or block=True. In
        single-writer mode ranks other than 0 return at once; in sharded
        mode every rank copies and writes the blocks it owns."""
        self._raise_pending()
        flat = _flatten(tree)
        t0 = _time.perf_counter()
        if self._resolve_sharded(flat):
            os.makedirs(self.directory, exist_ok=True)
            host, entries, gmeta = self._extract_shards(step, flat)
            target, args = self._write_sharded, (step, host, entries, gmeta)
        else:
            if not self.is_writer:
                return
            bad = [k for k, v in flat.items() if _is_shard(v)]
            if bad:
                raise ValueError(
                    "%s is sharded over the mesh: a single-writer "
                    "checkpoint cannot hold it (sharded=False); save it "
                    "sharded, or pass the host form of the state" % bad[0])
            host = {k: _host(v) for k, v in flat.items()}
            target, args = self._write, (step, host)
        rec = {"step": int(step), "copy_s": _time.perf_counter() - t0,
               "write_s": None}
        args = args + (rec,)
        self.wait(_barrier=False)  # one save at a time: bounded memory,
        self.save_log.append(rec)  # no write races
        if self.async_save and not block:
            self._worker = threading.Thread(target=target, args=args,
                                            daemon=True)
            self._worker.start()
        else:
            target(*args)

    def _manifest_path(self, step):
        return os.path.join(self.directory, "ckpt-%d.manifest.json" % step)

    def _shard_basename(self, step, index=None):
        return "ckpt-%d.shard%dof%d" % (
            step, self.process_index if index is None else index,
            self.process_count)

    # -- sharded save: ownership plan + host extraction ---------------------
    def _owner_of(self, rank):
        """The process that writes the blocks `rank` holds: the rank
        itself in a real world; under emulation (process_count other than
        the world's size) contiguous blocks of the world's ranks."""
        n = self.process_count
        real = _world()[1]
        if n == real:
            return int(rank)
        return (int(rank) * n) // max(real, 1)

    def _extract_shards(self, step, flat):
        """Host-copy every entry THIS process owns (synchronously) and
        build the per-host and global manifest metadata. The ownership
        plan is a pure function of the tree's layouts, so every rank
        computes the same plan without communicating: each distinct block
        of a sharded tensor gets one writer (its holders rotate by
        (array, block) for balance); whole leaves round-robin across
        processes."""
        me, n = self.process_index, self.process_count
        host, entries, arrays = {}, {}, {}
        mesh_axes = None
        for seq, key in enumerate(sorted(flat)):
            v = flat[key]
            if _is_shard(v) and v.shards > 1:
                if mesh_axes is None:
                    mesh_axes = {str(a): int(s)
                                 for a, s in v.mesh_axes.items()}
                arrays[key] = {"shape": list(v.shape),
                               "dtype": _dtype_name(v.data),
                               "spec": v.spec, "shards": v.shards}
                j = v.shard
                owner = self._owner_of(
                    v.holders[(seq + j) % len(v.holders)])
                if owner == me:
                    entry = "%s@s%d" % (key, j)
                    host[entry] = _host(v.data)
                    entries[entry] = {"key": key,
                                      "index": [list(p) for p in v.index]}
                continue
            if _is_shard(v):
                v = v.data
            arrays[key] = {"shape": [int(s) for s in np.shape(v)],
                           "dtype": _dtype_name(v),
                           "spec": None, "shards": 1}
            if seq % n == me:
                host[key] = _host(v)
                entries[key] = {"key": key, "index": None}
        gmeta = {"step": int(step), "format": "sharded",
                 "process_count": n,
                 "mesh": {"axes": mesh_axes or {}},
                 "files": [self._shard_basename(step, i) + ".npz"
                           for i in range(n)],
                 "arrays": arrays,
                 "note": "per-file sha256: each shard's .manifest.json "
                         "sidecar certifies its own file"}
        return host, entries, gmeta

    # -- IO primitives (each publish operation retries transients) ----------
    def _io_retry(self, fn):
        from . import retry
        deadline = self.deadline_fn() if self.deadline_fn else None
        return retry(fn, attempts=self.io_retries, backoff=0.05,
                     jitter=0.5, retry_on=OSError, deadline_s=deadline,
                     on_retry=lambda e, i: self._metrics["retries"].inc(
                         error=str(e), attempt=i))

    def _write_npz(self, path, host):
        def go():
            with open(path, "wb") as f:
                # npz written by hand: np.savez(**host) would collide with
                # its own parameter names for user keys, and the fd is
                # needed for fsync anyway
                with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as z:
                    for k, v in host.items():
                        buf = io.BytesIO()
                        np.lib.format.write_array(buf, np.asarray(v),
                                                  allow_pickle=False)
                        z.writestr(k + ".npy", buf.getvalue())
                f.flush()
                os.fsync(f.fileno())
        self._io_retry(go)

    def _sha_size(self, path):
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                digest.update(block)
        return digest.hexdigest(), os.path.getsize(path)

    def _publish_json(self, obj, final_path):
        tmp = final_path + ".tmp-%d" % os.getpid()

        def go():
            with open(tmp, "w") as f:
                json.dump(obj, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final_path)
        self._io_retry(go)

    def _published(self, step, final, size, t0, rec):
        """The common tail of a publish: directory fsync, instruments,
        chaos corruption, retention."""
        _fsync_dir(self.directory)
        rec["write_s"] = _time.perf_counter() - t0
        self._metrics["save_s"].observe(rec["write_s"])
        self._metrics["bytes"].set(size)
        self._metrics["saves"].inc()
        _chaos.maybe_corrupt_checkpoint(step, final)
        self._prune()

    def _write(self, step, host, rec):
        try:
            with telemetry.span("ckpt.write", category="ckpt", step=step):
                final = os.path.join(self.directory, "ckpt-%d.npz" % step)
                tmp = final + ".tmp-%d" % os.getpid()
                t0 = _time.perf_counter()
                self._write_npz(tmp, host)
                sha, size = self._sha_size(tmp)
                manifest = {"step": int(step),
                            "file": os.path.basename(final),
                            "size": size,
                            "sha256": sha,
                            "arrays": sorted(host.keys())}
                _chaos.maybe_kill_during_save(step)
                self._io_retry(lambda: os.replace(tmp, final))  # atomic
                self._publish_json(manifest, self._manifest_path(step))
                self._published(step, final, size, t0, rec)
            self._notify(True)
        except Exception as e:  # surfaced on the next save()/wait()
            with self._lock:
                self._error = e
            self._notify(False, e)

    def _notify(self, ok, exc=None):
        """Best-effort publish-outcome observers; a raising callback
        never poisons the writer thread."""
        cb = self.on_success if ok else self.on_error
        if cb is None:
            return
        try:
            if ok:
                cb()
            else:
                cb(exc)
        except Exception:
            pass

    def _write_sharded(self, step, host, entries, gmeta, rec):
        try:
            with telemetry.span("ckpt.write_sharded", category="ckpt",
                                step=step,
                                process_index=self.process_index):
                base = self._shard_basename(step)
                final = os.path.join(self.directory, base + ".npz")
                tmp = final + ".tmp-%d" % os.getpid()
                t0 = _time.perf_counter()
                self._write_npz(tmp, host)
                sha, size = self._sha_size(tmp)
                _chaos.maybe_kill_during_save(step)
                self._io_retry(lambda: os.replace(tmp, final))
                manifest = {"step": int(step), "file": base + ".npz",
                            "size": size, "sha256": sha,
                            "process_index": self.process_index,
                            "process_count": self.process_count,
                            "entries": entries}
                self._publish_json(manifest,
                                   os.path.join(self.directory,
                                                base + ".manifest.json"))
                if self.is_writer:
                    self._publish_json(gmeta, self._manifest_path(step))
                self._published(step, final, size, t0, rec)
            self._notify(True)
        except Exception as e:  # surfaced on the next save()/wait()
            with self._lock:
                self._error = e
            self._notify(False, e)

    def _prune(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            names = [self._shard_basename(s) + ".npz",
                     self._shard_basename(s) + ".manifest.json"]
            if self.is_writer:
                names += ["ckpt-%d.npz" % s,
                          os.path.basename(self._manifest_path(s))]
                # the writer also sweeps shard files of OTHER process
                # counts (an elastic relaunch must not leak the old
                # world's files forever), but not another process's
                # write in flight: hosts of an emulated pod run at their
                # own pace, so a fast writer prunes steps a slower host
                # is still writing (the reference removes its temp file)
                prefix = "ckpt-%d.shard" % s
                try:
                    names += [nm for nm in os.listdir(self.directory)
                              if nm.startswith(prefix)
                              and ".tmp-" not in nm]
                except OSError:
                    pass
            for nm in set(names):
                try:
                    os.remove(os.path.join(self.directory, nm))
                except OSError:
                    pass

    def wait(self, _barrier=True):
        """Block until the in-flight async save (if any) has published.
        The BARRIER POINT: every rank calls it at the same program point;
        in a world of several ranks they then synchronize, so none can
        go on (or exit for a relaunch) before the checkpoint is on disk.
        A real world only: emulated hosts share nothing but the
        directory."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self._raise_pending()
        _, size, world = _world()
        if _barrier and world and self.process_count == size:
            import torch.distributed as dist
            dist.barrier()

    def _raise_pending(self):
        with self._lock:
            if self._error is not None:
                e, self._error = self._error, None
                raise e

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = _CKPT_RE.match(name) or _SHARD_RE.match(name)
            if m:
                out.add(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _verify_manifest(self, step, path):
        """Integrity gate before deserialization. A missing manifest is
        tolerated (pre-manifest checkpoints stay restorable); a corrupt
        or mismatching one raises ValueError, which restore_latest()
        treats as corruption (falls back to an older step)."""
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            return
        with open(mpath) as f:
            manifest = json.load(f)  # corrupt JSON -> ValueError
        if not isinstance(manifest, dict) or "sha256" not in manifest:
            raise ValueError("manifest %s is missing the checksum" % mpath)
        sha, size = self._sha_size(path)
        if manifest.get("size") not in (None, size):
            raise ValueError(
                "checkpoint ckpt-%d.npz is %d bytes but its manifest "
                "recorded %d — truncated write" % (step, size,
                                                   manifest["size"]))
        if sha != manifest["sha256"]:
            raise ValueError("checkpoint ckpt-%d.npz fails its manifest "
                             "sha256 — corrupt" % step)

    def global_manifest(self, step):
        """The step's global manifest dict, or None when absent (a
        sharded step's carries format / process_count / mesh / arrays)."""
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            g = json.load(f)  # corrupt JSON -> ValueError
        if not isinstance(g, dict):
            raise ValueError("manifest %s is not an object" % mpath)
        return g

    def _verify_shard(self, path):
        """Integrity gate for one shard file: its sidecar manifest must
        exist and its size and sha256 match. Returns the manifest."""
        mpath = path[:-len(".npz")] + ".manifest.json"
        if not os.path.exists(mpath):
            raise ValueError("shard %s has no sidecar manifest" % path)
        with open(mpath) as f:
            m = json.load(f)
        if not isinstance(m, dict) or "sha256" not in m:
            raise ValueError("shard manifest %s is missing the checksum"
                             % mpath)
        size = os.path.getsize(path)
        if m.get("size") not in (None, size):
            raise ValueError("shard %s is %d bytes but its manifest "
                             "recorded %d — truncated write"
                             % (path, size, m["size"]))
        sha, _ = self._sha_size(path)
        if sha != m["sha256"]:
            raise ValueError("shard %s fails its manifest sha256 — corrupt"
                             % path)
        return m

    def _verify_step(self, step):
        """Raise when `step` is not fully intact on this host's view of
        the directory: for a sharded step every file of the roster must
        exist and verify (a host that died mid-save leaves the step
        incomplete); for a single-file step the manifest check."""
        g = self.global_manifest(step)
        if g is not None and g.get("format") == "sharded":
            for fname in g.get("files", []):
                path = os.path.join(self.directory, fname)
                if not os.path.exists(path):
                    raise ValueError(
                        "sharded checkpoint step %d is missing %s — "
                        "incomplete save (a host died before publishing)"
                        % (step, fname))
                self._verify_shard(path)
            return
        path = os.path.join(self.directory, "ckpt-%d.npz" % step)
        if not os.path.exists(path):
            raise ValueError("step %d has shard files but no global "
                             "manifest — the manifest writer never "
                             "published" % step)
        self._verify_manifest(step, path)

    def step_files(self, step):
        """Every existing file of `step` (single-file npz + manifest,
        every shard npz + sidecar, the global manifest): the demotion and
        audit unit."""
        step = int(step)
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        single = "ckpt-%d.npz" % step
        shard_prefix = "ckpt-%d.shard" % step
        manifest = os.path.basename(self._manifest_path(step))
        for name in sorted(names):
            if name == single or name == manifest \
                    or (name.startswith(shard_prefix)
                        and (name.endswith(".npz")
                             or name.endswith(".manifest.json"))):
                out.append(os.path.join(self.directory, name))
        return out

    def demote(self, step, reason=""):
        """Take `step` out of the restorable set: every one of its files
        is renamed with a `.corrupt` suffix (kept as evidence, invisible
        to `all_steps()`). The checkpoint auditor calls this when a
        published checkpoint later fails re-verification. Returns the
        renamed paths."""
        renamed = []
        for path in self.step_files(step):
            try:
                os.replace(path, path + ".corrupt")
                renamed.append(path)
            except OSError:
                continue
        if renamed:
            _fsync_dir(self.directory)
            self._metrics["manifest_failures"].inc(step=int(step),
                                                   error=reason
                                                   or "demoted")
            telemetry.flight().record(
                "event", "train.ckpt_demoted", step=int(step),
                reason=str(reason)[:200], files=len(renamed))
        return renamed

    def intact_steps(self):
        """Steps whose checkpoints fully verify on this host (sharded:
        every shard file present and checksummed). Corrupt or incomplete
        steps are skipped with a warning."""
        out = []
        for step in self.all_steps():
            try:
                self._verify_step(step)
                out.append(step)
            except _CORRUPT as e:
                self._metrics["manifest_failures"].inc(step=step,
                                                       error=str(e))
                warnings.warn("skipping corrupt checkpoint step %d: %s"
                              % (step, e))
        return out

    def _common_steps(self, steps):
        """The steps intact on EVERY rank of the world (each rank's view
        allgathered and intersected), so ranks never fall back past
        different corrupt checkpoints onto different steps."""
        if not _world()[2]:
            return list(steps)
        import torch.distributed as dist
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, sorted(int(s) for s in steps))
        common = set(rows[0])
        for r in rows[1:]:
            common &= set(r)
        return sorted(common)

    def _restore_sharded(self, step, g):
        """Reassemble global arrays from whichever shard files cover
        them. The index ranges in the per-host manifests are global
        coordinates, so a checkpoint of n hosts restores under any other
        count; the caller places the arrays under its own layout."""
        arrays = g.get("arrays", {})
        out, covered = {}, {}
        for fname in g.get("files", []):
            path = os.path.join(self.directory, fname)
            if not os.path.exists(path):
                raise ValueError(
                    "sharded checkpoint step %d is missing %s — "
                    "incomplete save (a host died before publishing)"
                    % (step, fname))
            m = self._verify_shard(path)
            archive = np.load(path, allow_pickle=False)
            for entry, info in m.get("entries", {}).items():
                key = info["key"]
                data = archive[entry]
                if info.get("index") is None:
                    out[key] = data
                    continue
                meta = arrays.get(key)
                if meta is None:
                    raise ValueError("shard entry %r is not in the "
                                     "global manifest" % entry)
                if key not in out:
                    out[key] = np.empty([int(s) for s in meta["shape"]],
                                        np.dtype(meta["dtype"]))
                    covered[key] = 0
                slices = tuple(slice(int(a), int(b))
                               for a, b in info["index"])
                out[key][slices] = data
                covered[key] += int(data.size)
        for key, meta in arrays.items():
            if key not in out:
                raise ValueError("sharded checkpoint step %d never wrote "
                                 "%r — shard files incomplete" % (step, key))
            if int(meta.get("shards", 1)) > 1:
                want = int(np.prod(meta["shape"])) if meta["shape"] else 1
                if covered.get(key, 0) != want:
                    raise ValueError(
                        "array %r covered %d of %d elements — shard "
                        "files incomplete" % (key, covered.get(key, 0),
                                              want))
        return _unflatten(out)

    def restore(self, step):
        g = self.global_manifest(step)
        if g is not None and g.get("format") == "sharded":
            return self._restore_sharded(step, g)
        path = os.path.join(self.directory, "ckpt-%d.npz" % step)
        self._verify_manifest(step, path)
        archive = np.load(path, allow_pickle=False)
        return _unflatten({k: archive[k] for k in archive.files})

    def restore_latest(self):
        """(step, tree) of the newest checkpoint intact on EVERY rank, or
        None. A corrupt file or manifest falls back (with a warning) to
        the previous one; only corruption-shaped errors fall back, so a
        systematic restore bug never silently becomes a cold start. In a
        world of several ranks the per-rank intact sets are allgathered
        and intersected before deserializing; alone (and for emulated
        hosts sharing one directory) verification stays lazy, newest
        first."""
        if _world()[2]:
            candidates = self._common_steps(self.intact_steps())
        else:
            candidates = self.all_steps()
        for step in reversed(candidates):
            try:
                t0 = _time.perf_counter()
                with telemetry.span("ckpt.restore", category="ckpt",
                                    step=step):
                    tree = self.restore(step)
                self._metrics["restore_s"].observe(
                    _time.perf_counter() - t0)
                self._metrics["restores"].inc()
                return step, tree
            except _CORRUPT as e:
                self._metrics["manifest_failures"].inc(step=step,
                                                       error=str(e))
                warnings.warn("skipping corrupt checkpoint step %d: %s"
                              % (step, e))
                continue
        return None


_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix + "__ed__"] = np.zeros(0)  # empty-dict marker
        for k, v in tree.items():
            out.update(_flatten(v, prefix + str(k) + _SEP))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[prefix + ("__et__" if isinstance(tree, tuple)
                          else "__el__")] = np.zeros(0)
        tag = "__t__" if isinstance(tree, tuple) else "__l__"
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + tag + str(i) + _SEP))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _unflatten(flat):
    root = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys == ["__et__"]:
            return ()
        if keys == ["__el__"]:
            return []
        if keys == ["__ed__"]:
            return {}
        if keys and all(k.startswith(("__t__", "__l__")) for k in keys):
            tup = keys[0].startswith("__t__")
            items = sorted(((int(k[5:]), rebuild(v))
                            for k, v in node.items()))
            seq = [v for _, v in items]
            return tuple(seq) if tup else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)
