#!/usr/bin/env python
"""Environment diagnostics for bug reports (port of tools/diagnose.py):
OS, Python, numpy, torch, the CUDA runtime and nvcc, the card (name,
power limit, SMs, memory), the state of the port's kernel build directory
and native library, and the relevant environment variables.

    python -m mxnet_tpu_torch.tools.diagnose                 # the card
    python -m mxnet_tpu_torch.tools.diagnose --device cpu
    python -m mxnet_tpu_torch.tools.diagnose --no-device-probe

Safe to run anywhere: the device probe runs in a SUBPROCESS with a
timeout, because a wedged driver can hang the first CUDA call. With
`--device cuda` (the default) a probe that finds no card ends the report
with a SystemExit naming it, after everything else has printed.
"""
import argparse
import glob
import os
import platform
import shutil
import subprocess
import sys

from mxnet_tpu_torch.tools import add_device_flag

_ENV_PREFIXES = ("MXNET_", "TORCH_", "CUDA_", "NCCL_", "DMLC_")

#: run in a fresh process: what torch and nvidia-smi say of the card
_PROBE_CUDA = r"""
import subprocess, torch
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
print("devices     :", torch.cuda.device_count())
for i in range(torch.cuda.device_count()):
    p = torch.cuda.get_device_properties(i)
    print("cuda:%d      : %s, capability %d.%d, %d SMs, %.1f GB"
          % (i, p.name, p.major, p.minor, p.multi_processor_count,
             p.total_memory / 1e9))
try:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
except (OSError, subprocess.SubprocessError) as e:
    smi = "nvidia-smi failed: %s" % e
print("nvidia-smi  :", smi)
"""

#: run in a fresh process: torch's CPU side
_PROBE_CPU = r"""
import torch
print("device      : cpu, %d threads, %d interop threads"
      % (torch.get_num_threads(), torch.get_num_interop_threads()))
print("cuda        :", "available" if torch.cuda.is_available()
      else "not available")
"""


def section(title):
    print("\n----- %s -----" % title)


def probe_devices(device, timeout):
    """(ok, text) of the device probe run in a subprocess."""
    code = _PROBE_CUDA if device == "cuda" else _PROBE_CPU
    try:
        out = subprocess.run([sys.executable, "-c", code], timeout=timeout,
                             capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return False, ("probe timed out after %ds: the driver is wedged or "
                       "the card unreachable" % timeout)
    if out.returncode == 0:
        return True, out.stdout.strip()
    return False, "probe failed (rc=%d): %s" % (
        out.returncode, out.stderr.strip()[-500:])


def nvcc_version():
    """The toolkit's nvcc and its release line, or why there is none."""
    from mxnet_tpu_torch.ops import _cuda
    try:
        nvcc = _cuda._nvcc()
    except Exception as e:  # the port's own message names what is missing
        return "MISSING (%s)" % e
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return "%s (failed: %s)" % (nvcc, e)
    release = [ln for ln in out.splitlines() if "release" in ln]
    return "%s (%s)" % (nvcc, release[-1].strip() if release else "?")


def build_state():
    """Lines on the port's kernel build directory and AOT cache."""
    from mxnet_tpu_torch import aot
    from mxnet_tpu_torch.ops import _cuda
    lines = ["directory   : %s (%s)" % (
        _cuda.BUILD_DIR, "exists" if os.path.isdir(_cuda.BUILD_DIR)
        else "not made yet: kernels build at their first launch")]
    libs = sorted(glob.glob(os.path.join(_cuda.BUILD_DIR, "*.so")))
    lines.append("libraries   : %d built" % len(libs))
    lines += ["  %s (%d bytes)" % (os.path.basename(p), os.path.getsize(p))
              for p in libs]
    lines.append("sources     : %s" % ", ".join(sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(
            _cuda._CSRC, "*.cu")))))
    lines.append("aot cache   : %s" % (aot.cache_dir() or "off"))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeout", type=int, default=60,
                    help="device probe timeout, seconds")
    ap.add_argument("--no-device-probe", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    section("Platform")
    print("system      :", platform.platform())
    print("machine     :", platform.machine())
    print("python      :", sys.version.replace("\n", " "))

    section("Versions")
    import numpy
    import torch
    import mxnet_tpu_torch
    print("numpy       :", numpy.__version__)
    print("torch       :", torch.__version__)
    print("cuda runtime:", torch.version.cuda or "none (a CPU build)")
    print("cudnn       :", torch.backends.cudnn.version()
          if torch.backends.cudnn.is_available() else "none")
    print("nvcc        :", nvcc_version())
    print("nvidia-smi  :", shutil.which("nvidia-smi") or "not found")
    print("mxnet_tpu_torch:", getattr(mxnet_tpu_torch, "__version__",
                                      "dev"))

    section("Kernel build")
    for line in build_state():
        print(line)

    section("Native extension")
    from mxnet_tpu_torch import native
    print("available   :", native.AVAILABLE)
    if not native.AVAILABLE:
        print("(builds with g++ and libjpeg at first use: %s)"
              % native.build_error())

    section("Environment")
    for k in sorted(os.environ):
        if k.startswith(_ENV_PREFIXES):
            print("%s=%s" % (k, os.environ[k]))

    if args.no_device_probe:
        return 0
    section("Device %s (subprocess probe, %ds timeout)"
            % (args.device, args.timeout))
    ok, text = probe_devices(args.device, args.timeout)
    print(text)
    if not ok and args.device == "cuda":
        raise SystemExit("--device cuda: the card probe failed (%s); pass "
                         "--device cpu on a machine without one"
                         % text.splitlines()[-1])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
