// mxtpu_predict: run an exported artifact's AOTInductor package from C++
// (the port of the reference's cpp-package/src/predict_cli.cc).
//
//   mxtpu_predict <artifact> [--device D] [--input i=path]...
//       [--output-dir DIR] [--repeat N] [--echo-input-check] [--verbose]
//
// --device     "cuda:0" (the default), "cuda" or "cpu".
// --input      raw bytes of input i (its signature's dtype and size); the
//              inputs not given are the reference's ramp (byte i % 251).
// --output-dir writes output i's raw bytes to DIR/out<i>.bin.
// --repeat N   then runs N more forwards on inputs staged on the device
//              and prints "forward ms: <mean>" (each ended by a sync).
// --echo-input-check  fails unless output 0 byte-equals input 0.
// --verbose    prints "rnn_fwd calls: C, K4a launches: K": the C++ op's
//              calls and K4a's launches in the first forward.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "mxtpu/predictor.hpp"

namespace {

std::vector<uint8_t> read_raw(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open input file " + path);
  return std::vector<uint8_t>((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
}

void write_raw(const std::string& path, const std::vector<uint8_t>& data) {
  std::ofstream f(path, std::ios::binary);
  f.write(reinterpret_cast<const char*>(data.data()), data.size());
  if (!f) throw std::runtime_error("cannot write " + path);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <artifact> [--device D] [--input i=path]... "
                 "[--output-dir DIR] [--repeat N] [--echo-input-check] "
                 "[--verbose]\n", argv[0]);
    return 2;
  }
  std::string device = "cuda:0", out_dir;
  std::vector<std::pair<int, std::string>> files;
  int repeat = 0;
  bool echo_check = false, verbose = false;
  try {
    for (int i = 2; i < argc; ++i) {
      if (std::strcmp(argv[i], "--device") == 0 && i + 1 < argc) {
        device = argv[++i];
      } else if (std::strcmp(argv[i], "--input") == 0 && i + 1 < argc) {
        const char* spec = argv[++i];
        const char* eq = std::strchr(spec, '=');
        if (eq == nullptr)
          throw std::runtime_error(std::string("--input needs i=path: ") +
                                   spec);
        files.emplace_back(std::atoi(std::string(spec, eq).c_str()),
                           eq + 1);
      } else if (std::strcmp(argv[i], "--output-dir") == 0 && i + 1 < argc) {
        out_dir = argv[++i];
      } else if (std::strcmp(argv[i], "--repeat") == 0 && i + 1 < argc) {
        repeat = std::atoi(argv[++i]);
      } else if (std::strcmp(argv[i], "--echo-input-check") == 0) {
        echo_check = true;
      } else if (std::strcmp(argv[i], "--verbose") == 0) {
        verbose = true;
      } else {
        std::fprintf(stderr, "unknown argument: %s\n", argv[i]);
        return 2;
      }
    }
    mxtpu::Predictor pred(argv[1], device);
    std::printf("platform: %s\n", pred.platform().c_str());

    std::vector<mxtpu::Tensor> inputs;
    for (const mxtpu::Tensor& spec : pred.input_specs()) {
      mxtpu::Tensor t = spec;
      t.data.resize(t.byte_size());
      for (size_t i = 0; i < t.data.size(); ++i)
        t.data[i] = static_cast<uint8_t>(i % 251);
      inputs.push_back(std::move(t));
    }
    for (const auto& [index, path] : files) {
      if (index < 0 || static_cast<size_t>(index) >= inputs.size())
        throw std::runtime_error("--input index out of range: " +
                                 std::to_string(index));
      std::vector<uint8_t> raw = read_raw(path);
      if (raw.size() != inputs[index].byte_size())
        throw std::runtime_error(
            "input " + std::to_string(index) + " expects " +
            std::to_string(inputs[index].byte_size()) + " bytes, " + path +
            " holds " + std::to_string(raw.size()));
      inputs[index].data = std::move(raw);
    }

    mxtpu_rnn_fwd_reset_launches();
    std::vector<mxtpu::Tensor> outs = pred.forward(inputs);
    const long long launches = mxtpu_rnn_fwd_launches();
    const long long calls = mxtpu_rnn_fwd_calls();
    for (size_t i = 0; i < outs.size(); ++i) {
      std::printf("output %zu: %s [", i, mxtpu::dtype_name(outs[i].dtype));
      for (size_t d = 0; d < outs[i].dims.size(); ++d)
        std::printf("%s%lld", d ? "," : "",
                    static_cast<long long>(outs[i].dims[d]));
      std::printf("] %zu bytes", outs[i].data.size());
      if (outs[i].dtype == mxtpu::DType::kF32 && !outs[i].data.empty()) {
        float v0;
        std::memcpy(&v0, outs[i].data.data(), sizeof(v0));
        std::printf(" first=%g", static_cast<double>(v0));
      }
      std::printf("\n");
      if (!out_dir.empty())
        write_raw(out_dir + "/out" + std::to_string(i) + ".bin",
                  outs[i].data);
    }
    if (verbose)
      std::printf("rnn_fwd calls: %lld, K4a launches: %lld\n", calls,
                  launches);
    if (repeat > 0) {
      const double ms = pred.time_forward(inputs, repeat);
      std::printf("forward ms: %.6f (%d runs)\n", ms, repeat);
    }
    if (echo_check) {
      if (outs.empty() || outs[0].data != inputs[0].data) {
        std::fprintf(stderr, "echo check FAILED\n");
        return 1;
      }
      std::printf("echo check OK\n");
    }
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
}
