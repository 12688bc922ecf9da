// mxtpu_train: train from an export_train_step artifact in C++ (the port
// of the reference's cpp-package/src/train_cli.cc).
//
//   mxtpu_train <train artifact> [--device D] [--steps N] [--lr V]
//       [--num-classes C] [--expect-decreasing] [--state-roundtrip-check]
//       [--state-out DIR] [--seed-base S] [--verbose]
//
// Feeds the reference's synthetic batches: step t draws from an LCG seeded
// with t (the same constants), x uniform in [-1, 1) and the labels
// next() % C (as a float class index where the label slot is f32; the
// reference drew uniform floats there), then seed = S + t (S = 0 by
// default, as the reference's seed = t), lr and t. The state
// stays on the device; each step prints its loss and ms, and the run the
// mean step ms after the first.
// --expect-decreasing    exits 1 unless the last loss < the first.
// --state-roundtrip-check uploads the initial state and reads it back
//                        byte for byte, with no step.
// --state-out DIR        writes the final state to DIR/state<i>.bin.
// --seed-base S          seeds step t's stochastic ops with S + t.
// --verbose              prints the C++ op's calls and K4a's launches
//                        over the steps.
#include <chrono>
#include <cinttypes>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "mxtpu/predictor.hpp"

namespace {

// the reference's LCG (train_cli.cc:29-43), constant for constant
struct Lcg {
  uint64_t s;
  explicit Lcg(uint64_t seed) : s(seed * 6364136223846793005ull + 1) {}
  uint32_t next() {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    return static_cast<uint32_t>(s >> 33);
  }
  float uniform() {  // [-1, 1)
    return static_cast<float>(next()) / 2147483648.0f - 1.0f;
  }
};

void fill_batch(mxtpu::Tensor* t, Lcg* rng, int num_classes, bool labels) {
  t->data.resize(t->byte_size());
  const int64_t n = t->num_elements();
  if (labels && t->dtype == mxtpu::DType::kS32) {
    int32_t* p = reinterpret_cast<int32_t*>(t->data.data());
    for (int64_t i = 0; i < n; ++i)
      p[i] = static_cast<int32_t>(rng->next() % num_classes);
  } else if (labels && t->dtype == mxtpu::DType::kS64) {
    int64_t* p = reinterpret_cast<int64_t*>(t->data.data());
    for (int64_t i = 0; i < n; ++i)
      p[i] = static_cast<int64_t>(rng->next() % num_classes);
  } else if (labels && t->dtype == mxtpu::DType::kF32) {
    float* p = reinterpret_cast<float*>(t->data.data());
    for (int64_t i = 0; i < n; ++i)
      p[i] = static_cast<float>(rng->next() % num_classes);
  } else if (!labels && t->dtype == mxtpu::DType::kF32) {
    float* p = reinterpret_cast<float*>(t->data.data());
    for (int64_t i = 0; i < n; ++i) p[i] = rng->uniform();
  } else {
    throw std::runtime_error(std::string("unsupported batch input dtype ") +
                             mxtpu::dtype_name(t->dtype));
  }
}

template <typename T>
mxtpu::Tensor scalar(mxtpu::DType dtype, T v) {
  mxtpu::Tensor t;
  t.dtype = dtype;
  t.data.resize(sizeof(T));
  std::memcpy(t.data.data(), &v, sizeof(T));
  return t;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <train artifact> [--device D] [--steps N] "
                 "[--lr V] [--num-classes C] [--expect-decreasing] "
                 "[--state-roundtrip-check] [--state-out DIR] "
                 "[--seed-base S] [--verbose]\n", argv[0]);
    return 2;
  }
  std::string device = "cuda:0", state_out;
  int steps = 10, num_classes = 10, seed_base = 0;
  float lr = 0.05f;
  bool expect_decreasing = false, roundtrip_only = false, verbose = false;
  try {
    for (int i = 2; i < argc; ++i) {
      if (std::strcmp(argv[i], "--device") == 0 && i + 1 < argc) {
        device = argv[++i];
      } else if (std::strcmp(argv[i], "--steps") == 0 && i + 1 < argc) {
        steps = std::atoi(argv[++i]);
      } else if (std::strcmp(argv[i], "--lr") == 0 && i + 1 < argc) {
        char* end = nullptr;
        lr = std::strtof(argv[++i], &end);
        if (end == argv[i] || *end != '\0')
          throw std::runtime_error(std::string("--lr is not a number: ") +
                                   argv[i]);
      } else if (std::strcmp(argv[i], "--num-classes") == 0 &&
                 i + 1 < argc) {
        num_classes = std::atoi(argv[++i]);
      } else if (std::strcmp(argv[i], "--expect-decreasing") == 0) {
        expect_decreasing = true;
      } else if (std::strcmp(argv[i], "--state-roundtrip-check") == 0) {
        roundtrip_only = true;
      } else if (std::strcmp(argv[i], "--state-out") == 0 && i + 1 < argc) {
        state_out = argv[++i];
      } else if (std::strcmp(argv[i], "--seed-base") == 0 && i + 1 < argc) {
        seed_base = std::atoi(argv[++i]);
      } else if (std::strcmp(argv[i], "--verbose") == 0) {
        verbose = true;
      } else {
        std::fprintf(stderr, "unknown argument: %s\n", argv[i]);
        return 2;
      }
    }
    if (steps < 1 || num_classes < 1) {
      std::fprintf(stderr, "--steps and --num-classes must be >= 1\n");
      return 2;
    }
    mxtpu::Predictor pred(argv[1], device);
    std::printf("platform: %s\n", pred.platform().c_str());
    if (!pred.is_train()) {
      std::fprintf(stderr, "%s is not a training artifact (no train.txt); "
                   "export with mxnet_tpu_torch.predict.export_train_step\n",
                   argv[1]);
      return 2;
    }
    const size_t k = pred.n_state();
    std::printf("state tensors: %zu, step inputs: %zu\n", k,
                pred.input_specs().size() - k);
    pred.load_state(pred.initial_state());
    if (roundtrip_only) {
      std::vector<mxtpu::Tensor> back = pred.read_state();
      const std::vector<mxtpu::Tensor> init = pred.initial_state();
      for (size_t i = 0; i < back.size(); ++i) {
        if (back[i].data != init[i].data) {
          std::fprintf(stderr, "state %zu did not round-trip\n", i);
          return 1;
        }
      }
      std::printf("state round-trip OK (%zu tensors)\n", back.size());
      return 0;
    }

    const std::vector<mxtpu::Tensor>& specs = pred.input_specs();
    if (specs.size() != k + 5)
      throw std::runtime_error("train artifact must have exactly "
                               "x,y,seed,lr,t after the state inputs");
    mxtpu_rnn_fwd_reset_launches();
    float first = 0, last = 0;
    double total_ms = 0;
    for (int t = 1; t <= steps; ++t) {
      Lcg rng(static_cast<uint64_t>(t));
      std::vector<mxtpu::Tensor> feed;
      mxtpu::Tensor x = specs[k];
      fill_batch(&x, &rng, num_classes, /*labels=*/false);
      mxtpu::Tensor y = specs[k + 1];
      fill_batch(&y, &rng, num_classes, /*labels=*/true);
      feed.push_back(std::move(x));
      feed.push_back(std::move(y));
      feed.push_back(scalar<int32_t>(mxtpu::DType::kS32, seed_base + t));
      feed.push_back(scalar<float>(mxtpu::DType::kF32, lr));
      feed.push_back(scalar<int32_t>(mxtpu::DType::kS32, t));  // t
      const auto t0 = std::chrono::steady_clock::now();
      const float loss = pred.train_step(feed);  // the loss read syncs
      const double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - t0).count();
      if (!std::isfinite(loss)) {
        std::fprintf(stderr, "step %d: loss is not finite (%g)\n", t,
                     static_cast<double>(loss));
        return 1;
      }
      if (t == 1) first = loss;
      else total_ms += ms;
      last = loss;
      std::printf("step %3d  loss %.9g  ms %.4f\n", t,
                  static_cast<double>(loss), ms);
    }
    if (steps > 1)
      std::printf("step ms: %.6f (mean of steps 2-%d)\n",
                  total_ms / (steps - 1), steps);
    std::vector<mxtpu::Tensor> final_state = pred.read_state();
    std::printf("final state: %zu tensors read back\n", final_state.size());
    if (!state_out.empty()) {
      for (size_t i = 0; i < final_state.size(); ++i) {
        std::ofstream f(state_out + "/state" + std::to_string(i) + ".bin",
                        std::ios::binary);
        f.write(reinterpret_cast<const char*>(final_state[i].data.data()),
                final_state[i].data.size());
        if (!f) throw std::runtime_error("cannot write the state to " +
                                         state_out);
      }
    }
    if (verbose)
      std::printf("rnn_fwd calls: %lld, K4a launches: %lld\n",
                  mxtpu_rnn_fwd_calls(), mxtpu_rnn_fwd_launches());
    if (expect_decreasing && !(last < first)) {
      std::fprintf(stderr, "loss did not decrease: first %g last %g\n",
                   static_cast<double>(first), static_cast<double>(last));
      return 1;
    }
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
}
