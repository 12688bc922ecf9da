#!/usr/bin/env python3
"""What the C++ half of the deployment path can stand on, read on this
host: the toolchain, libjpeg and PIL, torch's C++ headers and libraries,
AOTInductor's compile time, a g++-built binary running an AOTInductor
package, and an op of `mxnet_tpu_torch::rnn_fwd`'s schema called back from
that binary through AOTInductor's proxy executor.

    python tools/cpp_probe.py [--device cuda|cpu]   # repo root

Prints one JSON line a finding, then the card's name and power limit
(nvidia-smi) where there is a card, and a last line of everything. The
probe op lives in a namespace of its own (`mxtt_probe`), with the schema
string of `ops/fused_rnn.py`'s op, so nothing of the port's own op is
registered twice. Imports nothing of JAX and nothing of the JAX package;
imports nothing of the port either.
"""
import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SCHEMA = ("rnn_fwd(str mode, Tensor px, Tensor h0, Tensor? c0, Tensor wh, "
          "bool reverse) -> (Tensor, Tensor, Tensor, Tensor)")

#: the binary: registers the probe op (ys = px's first H columns + the
#: reverse flag, cs and cT empty, hT = ys[-1], counting its calls), loads
#: an AOTInductor package on the device asked for, runs it on a raw float32
#: input and writes the first output raw
PROBE_CC = r"""
#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/library.h>

#include <cstdio>
#include <fstream>
#include <string>
#include <vector>

static int g_calls = 0;

static std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> probe_rnn(
    c10::string_view mode, const at::Tensor& px, const at::Tensor& h0,
    const std::optional<at::Tensor>& c0, const at::Tensor& wh,
    bool reverse) {
  ++g_calls;
  const int64_t H = wh.size(1);
  at::Tensor ys = px.narrow(2, 0, H).contiguous() + (reverse ? 1.0 : 0.0);
  at::Tensor hT = ys.select(0, ys.size(0) - 1).contiguous();
  return {ys, px.new_empty({0}), hT, px.new_empty({0})};
}

TORCH_LIBRARY(mxtt_probe, m) { m.def("@SCHEMA@"); }
TORCH_LIBRARY_IMPL(mxtt_probe, CPU, m) { m.impl("rnn_fwd", probe_rnn); }
#ifdef PROBE_CUDA
TORCH_LIBRARY_IMPL(mxtt_probe, CUDA, m) { m.impl("rnn_fwd", probe_rnn); }
#endif

int main(int argc, char** argv) {
  // argv: package, device index (-1: CPU), input path, numel, output path
  const int dev = std::atoi(argv[2]);
  torch::inductor::AOTIModelPackageLoader loader(argv[1], "model", false, 1,
                                                 dev);
  const int64_t n = std::atoll(argv[4]);
  std::vector<float> host(n);
  std::ifstream(argv[3], std::ios::binary)
      .read(reinterpret_cast<char*>(host.data()), n * 4);
  at::Tensor x = at::from_blob(host.data(), {n}, at::kFloat).clone();
  x = x.to(dev < 0 ? at::Device(at::kCPU) : at::Device(at::kCUDA, dev));
  std::vector<at::Tensor> outs;
  for (int i = 0; i < 2; ++i) outs = loader.run({x.view({4, 2, 8})});
  at::Tensor y = outs[0].to(at::kCPU).contiguous();
  std::ofstream(argv[5], std::ios::binary)
      .write(reinterpret_cast<const char*>(y.data_ptr<float>()),
             y.numel() * 4);
  std::printf("{\"probe_op_calls\": %d, \"out_numel\": %lld}\n", g_calls,
              static_cast<long long>(y.numel()));
  return 0;
}
"""


def say(found, key, value):
    found[key] = value
    print(json.dumps({key: value}), flush=True)


def run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, **kw)


def toolchain(found):
    gxx = shutil.which("g++")
    say(found, "g++", [gxx, run([gxx, "--version"]).stdout.splitlines()[0]
                       if gxx else None, os.environ.get("CXX")])
    heads = [p for p in ("/usr/include/jpeglib.h",
                         "/usr/local/include/jpeglib.h")
             if os.path.exists(p)]
    heads += glob.glob("/usr/include/*/jpeglib.h")
    say(found, "jpeglib.h", heads)
    libs = run(["sh", "-c", "ldconfig -p | grep -i libjpeg"]).stdout
    say(found, "libjpeg", [ln.strip() for ln in libs.splitlines()])
    try:
        import PIL
        say(found, "PIL", PIL.__version__)
    except ImportError as e:
        say(found, "PIL", "missing: %s" % e)
    try:
        import cv2
        say(found, "cv2", cv2.__version__)
    except ImportError:
        say(found, "cv2", None)


def pick_cxx(found):
    """The first of $CXX, g++ on the PATH, /usr/bin/g++ and c++ that builds
    a shared object with -fopenmp, as AOTInductor's wrapper build needs
    (predict._inductor_cxx makes the same choice); each one's answer is a
    finding."""
    tried = {}
    for cxx in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
                shutil.which("c++")):
        if not cxx or cxx in tried or not os.path.exists(cxx):
            continue
        with tempfile.TemporaryDirectory() as d:
            p = subprocess.run(
                [cxx, "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-",
                 "-o", os.path.join(d, "t.so")],
                input="int f() { return 0; }\n", capture_output=True,
                text=True)
        tried[cxx] = p.returncode == 0 or p.stderr[-300:]
    say(found, "cxx_fopenmp", tried)
    return next((c for c, ok in tried.items() if ok is True), None)


def torch_facts(found, torch):
    from torch.utils import cpp_extension
    say(found, "torch", [torch.__version__, torch.version.cuda])
    say(found, "include_paths", cpp_extension.include_paths())
    lib_dirs = cpp_extension.library_paths()
    say(found, "library_paths", lib_dirs)
    say(found, "torch_libs", sorted(
        os.path.basename(p) for d in lib_dirs
        for p in glob.glob(os.path.join(d, "lib*.so"))))
    say(found, "GLIBCXX_USE_CXX11_ABI", bool(torch._C._GLIBCXX_USE_CXX11_ABI))
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "", "bin", "nvcc")
    say(found, "nvcc", run([nvcc, "--version"]).stdout.splitlines()[-1]
        if os.path.exists(nvcc) else None)


class Probe(object):
    """The probe op's Python side: the same namespace and schema, with a
    fake, so torch.export keeps it as one node."""

    def __init__(self, torch):
        lib = torch.library.Library("mxtt_probe", "DEF")
        lib.define(SCHEMA)

        def impl(mode, px, h0, c0, wh, reverse):
            H = wh.shape[1]
            ys = px[..., :H].contiguous() + (1.0 if reverse else 0.0)
            return ys, px.new_empty((0,)), ys[-1].contiguous(), \
                px.new_empty((0,))

        def fake(mode, px, h0, c0, wh, reverse):
            H = wh.shape[1]
            T, N = px.shape[0], px.shape[1]
            return px.new_empty((T, N, H)), px.new_empty((0,)), \
                px.new_empty((N, H)), px.new_empty((0,))
        for key in ("CPU", "CUDA"):
            lib.impl("rnn_fwd", impl, key)
        torch.library.register_fake("mxtt_probe::rnn_fwd", fake, lib=lib)
        self.lib = lib


def build(found, torch, work, cuda):
    from torch.utils import cpp_extension
    src = os.path.join(work, "probe.cc")
    with open(src, "w") as f:
        f.write(PROBE_CC.replace("@SCHEMA@", SCHEMA))
    lib_dir = cpp_extension.library_paths()[0]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    cmd = (["g++", "-std=c++20", "-O1", "-DPROBE_CUDA" if cuda else "-UX",
            "-D_GLIBCXX_USE_CXX11_ABI=%d"
            % int(torch._C._GLIBCXX_USE_CXX11_ABI)]
           + ["-I" + p for p in cpp_extension.include_paths()]
           + [src, "-o", os.path.join(work, "probe"), "-L" + lib_dir,
              "-Wl,-rpath," + lib_dir, "-Wl,--no-as-needed"] + libs)
    t0 = time.perf_counter()
    p = run(cmd)
    say(found, "g++_build", {"s": time.perf_counter() - t0,
                             "rc": p.returncode,
                             "stderr_tail": p.stderr[-3000:]})
    return p.returncode == 0


def aoti(found, torch, work, device):
    import torch._inductor
    probe = Probe(torch)  # noqa: F841 (keeps the registration alive)

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(8, 8)
            self.register_buffer("wh", torch.randn(4, 4))
            self.register_buffer("h0", torch.zeros(2, 4))

        def forward(self, x):
            px = torch.relu(self.fc(x))
            ys, _, hT, _ = torch.ops.mxtt_probe.rnn_fwd(
                "lstm", px, self.h0, None, self.wh, True)
            return ys * 2.0, hT

    cxx = pick_cxx(found)
    torch.manual_seed(25)
    m = Tiny().to(device)
    x = torch.randn(4, 2, 8, device=device)
    with torch.no_grad():
        want = m(x)[0].cpu().numpy()
    ep = torch.export.export(m, (x,), strict=False)
    say(found, "probe_op_nodes", sum(
        1 for n in ep.graph.nodes if "mxtt_probe" in str(n.target)))
    pkg = os.path.join(work, "tiny_%s.pt2" % device)
    with torch._inductor.config.patch({"cpp.cxx": (cxx,)}):
        t0 = time.perf_counter()
        torch._inductor.aoti_compile_and_package(ep, package_path=pkg)
        say(found, "aoti_compile_s_%s" % device, time.perf_counter() - t0)
        t0 = time.perf_counter()
        torch._inductor.aoti_compile_and_package(
            torch.export.export(m, (x,), strict=False),
            package_path=pkg[:-4] + "_again.pt2")
        say(found, "aoti_compile_again_s_%s" % device,
            time.perf_counter() - t0)
    return pkg, x.cpu().numpy(), want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import numpy as np
    import torch
    found = {}
    toolchain(found)
    torch_facts(found, torch)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="cpp_probe_")
    try:
        built = build(found, torch, work, cuda)
        pkg, x, want = aoti(found, torch, work, args.device)
        if built:
            xin, yout = (os.path.join(work, n) for n in ("x.bin", "y.bin"))
            x.astype(np.float32).tofile(xin)
            t0 = time.perf_counter()
            p = run([os.path.join(work, "probe"), pkg, "0" if cuda else "-1",
                     xin, str(x.size), yout], timeout=300)
            res = {"s": time.perf_counter() - t0, "rc": p.returncode,
                   "stdout": p.stdout[-2000:], "stderr": p.stderr[-3000:]}
            if p.returncode == 0:
                got = np.fromfile(yout, np.float32).reshape(want.shape)
                res["max_abs_err_vs_python"] = float(np.abs(got - want)
                                                     .max())
            say(found, "cpp_run_%s" % args.device, res)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if cuda:
        smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).stdout.strip()
        say(found, "nvidia-smi", smi)
    print(json.dumps(found))
    return 0


if __name__ == "__main__":
    sys.exit(main())
