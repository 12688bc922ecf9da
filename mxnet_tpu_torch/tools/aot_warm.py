#!/usr/bin/env python
"""Pre-populate (or verify, or purge) the port's persistent AOT cache
(port of tools/aot_warm.py).

A serving fleet with MXNET_AOT_CACHE_DIR set loads what a fresh process
would otherwise compile from disk: the kernel libraries (nvcc's builds of
`ops/csrc/*.cu`) and AOTInductor packages (`predict.compile_for_cpp`).
Somebody has to pay the FIRST build. This tool pays it offline: it builds
one engine with the serving flags (paged/tp/block-size/max-batch/
prefill-chunk pick the kernels a server launches) and drives it across
the shape lattice serving will hit: one prefill per prompt-length bucket,
one decode step per power-of-two batch bucket. Every kernel library built
is published to the cache; for `--model`, the artifact's AOTInductor
package for the device is compiled too (added to the artifact and
published). A later `serve --aot-cache DIR` (or a scale-up or respawn
inside an autoscaled fleet) then starts with zero nvcc builds and
bit-identical logits.

    python -m mxnet_tpu_torch.tools.aot_warm --cache /var/cache/mxtpu --demo --paged
    python -m mxnet_tpu_torch.tools.aot_warm --cache /var/cache/mxtpu \\
        --model lm.mxtpu --max-batch 8 --block-size 16
    python -m mxnet_tpu_torch.tools.aot_warm --cache /var/cache/mxtpu --verify
    python -m mxnet_tpu_torch.tools.aot_warm --cache /var/cache/mxtpu --purge

`--verify` integrity-checks every entry (sha256 over its payload,
format, readability) without loading any; exit status 1 when any entry is
corrupt. The supervised-relaunch loop (tools/train_supervise.py
--prewarm-cmd) can run this tool before each incarnation so a crashed
trainer restarts warm. `--device` is the card by default (a machine
without one exits naming it); `--verify` and `--purge` touch only files.
"""
import argparse
import os
import sys

from mxnet_tpu_torch.tools import add_device_flag, require_device


def _buckets(spec, hi):
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        n = int(tok)
        if n > 0 and n <= hi and n not in out:
            out.append(n)
    return out or [min(8, hi)]


def _batch_lattice(max_batch):
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _site_counts():
    """(nvcc builds, kernel-library warm loads, AOTInductor compiles,
    AOTInductor warm loads) the compile watchdog has counted so far."""
    from mxnet_tpu_torch.telemetry import introspect
    sites = introspect.watchdog().sites()
    kern = [s for n, s in sites.items() if n.startswith("kernels.")]
    pkg = sites.get("predict.compile_for_cpp")
    return (sum(s.compiles for s in kern), sum(s.cache_hits for s in kern),
            pkg.compiles if pkg else 0, pkg.cache_hits if pkg else 0)


def warm(args):
    device = require_device(args.device)
    from mxnet_tpu_torch import aot, predict, serving
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.tools.serve import demo_model

    if args.demo:
        adapter = serving.TransformerLM(*demo_model(device))
    elif args.model:
        adapter = serving.ExportedLM(args.model, device=device)
    else:
        raise SystemExit("pass --model artifact.mxtpu or --demo "
                         "(or --verify/--purge)")
    if not (args.cache or aot.cache_dir()):
        raise SystemExit("no cache directory (pass --cache or set "
                         "MXNET_AOT_CACHE_DIR)")
    before = _site_counts()
    eng = serving.Engine(adapter, max_batch=args.max_batch,
                         block_size=args.block_size,
                         paged=args.paged,
                         prefill_chunk=args.prefill_chunk,
                         tp=args.tp, device=device,
                         aot_cache=args.cache)
    max_len = getattr(adapter, "max_len", None) or 128
    lens = _buckets(args.prompt_buckets, max(1, max_len - 2))
    print("warming %s on %s: paged=%s tp=%s max_batch=%d block_size=%d "
          "prompt buckets %s, batch lattice %s"
          % (eng.aot_cache, device, "on" if eng.paged else "off",
             args.tp or 1, args.max_batch, args.block_size,
             lens, _batch_lattice(args.max_batch)))
    try:
        # one prefill per prompt-length bucket, one decode per batch bucket
        for bs in _batch_lattice(args.max_batch):
            for plen in lens:
                seqs = [eng.start([(i + t) % 32 + 1 for t in range(plen)],
                                  max_new=2)
                        for i in range(bs)]
                eng.decode_step(seqs)
                for s in seqs:
                    eng.release(s)
        first_runs = eng.prefill_compilations + eng.decode_compilations
        engine_warm = eng.warm_loads
    finally:
        eng.close()
    if args.model:
        ctx = Context("gpu" if device == "cuda" else "cpu", 0)
        predict.compile_for_cpp(args.model, ctx=ctx)
    after = _site_counts()
    nvcc, kwarm, pkgs, pwarm = (a - b for a, b in zip(after, before))
    n = len(_cache(args).entries())
    print("done: %d first run(s), %d warm load(s) (%d kernel librar%s, %d "
          "AOTInductor package%s), %d nvcc build(s), %d AOTInductor "
          "package(s) compiled, %d cache entr%s"
          % (first_runs, engine_warm + pwarm, kwarm,
             "y" if kwarm == 1 else "ies", pwarm, "" if pwarm == 1 else "s",
             nvcc, pkgs, n, "y" if n == 1 else "ies"))
    return 0


def _cache(args):
    from mxnet_tpu_torch import aot
    cdir = args.cache or aot.cache_dir()
    return aot.AOTCache(cdir) if cdir else None


def verify(args):
    cache = _cache(args)
    if cache is None:
        raise SystemExit("no cache directory (pass --cache or set "
                         "MXNET_AOT_CACHE_DIR)")
    ok, bad = cache.verify()
    print("verified %s: %d ok, %d corrupt"
          % (cache.path, len(ok), len(bad)))
    for name in bad:
        print("  CORRUPT %s" % name)
    return 1 if bad else 0


def purge(args):
    cache = _cache(args)
    if cache is None:
        raise SystemExit("no cache directory (pass --cache or set "
                         "MXNET_AOT_CACHE_DIR)")
    names = cache.entries()
    for name in names:
        try:
            os.remove(os.path.join(cache.path, name))
        except OSError:
            pass
    print("purged %d entr%s from %s"
          % (len(names), "y" if len(names) == 1 else "ies", cache.path))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="AOT cache directory (default: "
                         "MXNET_AOT_CACHE_DIR)")
    ap.add_argument("--model", default=None,
                    help=".mxtpu artifact from predict.export_model")
    ap.add_argument("--demo", action="store_true",
                    help="warm for the serve tool's --demo model")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--paged", action="store_true", default=None,
                    help="warm the paged-attention decode path "
                         "(default: MXNET_PAGED_ATTENTION)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk length (paged path)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel degree (default: "
                         "MXNET_SERVING_TP or 1)")
    ap.add_argument("--prompt-buckets", default="4,8,16,32",
                    metavar="L1,L2,...",
                    help="prompt-length buckets to prefill-warm "
                         "(default 4,8,16,32; clipped to the model's "
                         "max_len)")
    ap.add_argument("--verify", action="store_true",
                    help="integrity-check every cache entry instead of "
                         "warming; exit 1 on any corrupt entry")
    ap.add_argument("--purge", action="store_true",
                    help="delete every cache entry, then exit")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.verify:
        return verify(args)
    if args.purge:
        return purge(args)
    return warm(args)


if __name__ == "__main__":
    sys.exit(main())
