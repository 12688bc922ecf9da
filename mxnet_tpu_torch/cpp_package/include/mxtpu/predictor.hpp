// C++ inference and training over exported artifacts, on libtorch.
//
// The port of the reference's cpp-package predictor
// (cpp-package/include/mxtpu/predictor.hpp). The reference drives a PJRT
// plugin and compiles the artifact's StableHLO in C++; here the artifact
// carries an AOTInductor package per device (`aoti/cuda.pt2`,
// `aoti/cpu.pt2`), compiled in Python by
// `mxnet_tpu_torch.predict.compile_for_cpp` (or written by
// `export_train_step`), and this predictor runs it with libtorch's
// AOTIModelPackageLoader on the device it is given. No Python runs here.
//
// Artifact contract (mxnet_tpu_torch/predict.py): a STORE-only zip with
// `signature.txt` ("in|out <dtype> <d0>x<d1>..." a tensor), `meta.json`,
// `model.pt2` (the torch.export program) and `aoti/<device>.pt2`; a
// training artifact adds `train.txt` ("n_state K") and `state/<i>.bin`.
//
// This header names nothing of torch, so its users compile without
// torch's headers.
#ifndef MXTPU_PREDICTOR_HPP_
#define MXTPU_PREDICTOR_HPP_

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace mxtpu {

enum class DType { kF32, kF16, kF64, kBF16, kS32, kS64, kS8, kU8, kPred };

size_t dtype_bytes(DType t);
const char* dtype_name(DType t);

struct Tensor {
  DType dtype = DType::kF32;
  std::vector<int64_t> dims;
  std::vector<uint8_t> data;  // dense, row-major

  int64_t num_elements() const;
  size_t byte_size() const { return num_elements() * dtype_bytes(dtype); }
};

class Predictor {
 public:
  // Loads `artifact_path` and its AOTInductor package for `device`
  // ("cuda:0", "cuda", "cpu"). Throws std::runtime_error when the
  // artifact has no package for that device, naming compile_for_cpp.
  explicit Predictor(const std::string& artifact_path,
                     const std::string& device = "cuda:0");
  ~Predictor();

  const std::vector<Tensor>& input_specs() const;
  const std::vector<Tensor>& output_specs() const;

  // "gpu" on a CUDA device, "cpu" on the CPU.
  const std::string& platform() const;

  // One inference: `inputs` must match input_specs() in count, dtype,
  // dims and byte size. Returns host tensors.
  std::vector<Tensor> forward(const std::vector<Tensor>& inputs);

  // Mean milliseconds of one forward over `repeat` runs on inputs copied
  // to the device once, each run ended by a device synchronize (after
  // one run to warm up).
  double time_forward(const std::vector<Tensor>& inputs, int repeat);

  // ---- training artifacts (export_train_step) ---------------------------
  // Inputs [state_0..state_{K-1}, x, y, seed, lr, t]; outputs
  // [loss, state'_0..state'_{K-1}]. The state stays on the device between
  // steps; only the batch, the scalars and the loss cross to the host.
  bool is_train() const;
  size_t n_state() const;
  std::vector<Tensor> initial_state() const;
  void load_state(const std::vector<Tensor>& state);
  // One step: `step_inputs` are (x, y, seed, lr, t). `seed` seeds the
  // device's default generator before the step (the stochastic layers
  // draw from it). Returns the loss; the new state replaces the old.
  float train_step(const std::vector<Tensor>& step_inputs);
  std::vector<Tensor> read_state();

  Predictor(const Predictor&) = delete;
  Predictor& operator=(const Predictor&) = delete;

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace mxtpu

// The C++ op `mxnet_tpu_torch::rnn_fwd` (libmxtpu_torch_ops.so): K4a's
// launches (CUDA calls only), the op's calls on either device (the CPU
// scan's too), and both set to 0.
extern "C" long long mxtpu_rnn_fwd_launches(void);
extern "C" long long mxtpu_rnn_fwd_calls(void);
extern "C" void mxtpu_rnn_fwd_reset_launches(void);

#endif  // MXTPU_PREDICTOR_HPP_
