// C ABI over mxtpu::Predictor on libtorch (include/mxtpu/c_predict_api.h;
// the port of the reference's cpp-package/src/c_predict_api.cc). Every entry
// point catches everything, keeps the message in a thread-local and returns
// -1: no C++ exception crosses the boundary.
#include "mxtpu/c_predict_api.h"

#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "mxtpu/predictor.hpp"

namespace {

thread_local std::string g_last_error;

struct PredState {
  std::unique_ptr<mxtpu::Predictor> pred;
  std::string platform;
  std::vector<mxtpu::Tensor> inputs;     // staged, signature-shaped
  std::vector<bool> input_set;
  std::vector<mxtpu::Tensor> outputs;    // last Forward's results
  // scratch returned by GetInput/OutputShape; valid until the next call
  std::vector<int64_t> shape_scratch;
};

PredState* state(MXTPUPredictorHandle h) {
  if (h == nullptr) throw std::runtime_error("null predictor handle");
  return static_cast<PredState*>(h);
}

int fail(const std::exception& e) {
  g_last_error = e.what();
  return -1;
}

int slot_check(const std::vector<mxtpu::Tensor>& v, int index,
               const char* what) {
  if (index < 0 || static_cast<size_t>(index) >= v.size())
    throw std::runtime_error(std::string(what) + " index out of range: " +
                             std::to_string(index) + " (have " +
                             std::to_string(v.size()) + ")");
  return index;
}

}  // namespace

extern "C" {

const char* MXTPUPredGetLastError(void) { return g_last_error.c_str(); }

int MXTPUPredCreate(const char* artifact_path, const char* device,
                    const char* const* opt_specs, int num_opts,
                    MXTPUPredictorHandle* out) {
  (void)opt_specs;  // the reference's PJRT client options: none here
  (void)num_opts;
  try {
    if (artifact_path == nullptr || device == nullptr || out == nullptr)
      throw std::runtime_error(
          "MXTPUPredCreate: artifact_path, device and out are required");
    auto st = std::make_unique<PredState>();
    st->pred = std::make_unique<mxtpu::Predictor>(artifact_path, device);
    st->platform = st->pred->platform();
    st->inputs = st->pred->input_specs();  // dims/dtype set, data empty
    st->input_set.assign(st->inputs.size(), false);
    *out = st.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredGetPlatform(MXTPUPredictorHandle handle, const char** name) {
  try {
    if (name == nullptr) throw std::runtime_error("name is required");
    *name = state(handle)->platform.c_str();
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredGetInputCount(MXTPUPredictorHandle handle, int* count) {
  try {
    if (count == nullptr) throw std::runtime_error("count is required");
    *count = static_cast<int>(state(handle)->inputs.size());
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredGetOutputCount(MXTPUPredictorHandle handle, int* count) {
  try {
    if (count == nullptr) throw std::runtime_error("count is required");
    *count = static_cast<int>(state(handle)->pred->output_specs().size());
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

namespace {

int get_shape(PredState* st, const mxtpu::Tensor& t,
              const int64_t** shape_data, int* ndim,
              const char** dtype_name) {
  st->shape_scratch = t.dims;
  if (shape_data != nullptr) *shape_data = st->shape_scratch.data();
  if (ndim != nullptr) *ndim = static_cast<int>(st->shape_scratch.size());
  if (dtype_name != nullptr) *dtype_name = mxtpu::dtype_name(t.dtype);
  return 0;
}

}  // namespace

int MXTPUPredGetInputShape(MXTPUPredictorHandle handle, int index,
                           const int64_t** shape_data, int* ndim,
                           const char** dtype_name) {
  try {
    PredState* st = state(handle);
    slot_check(st->inputs, index, "input");
    return get_shape(st, st->inputs[index], shape_data, ndim, dtype_name);
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredGetOutputShape(MXTPUPredictorHandle handle, int index,
                            const int64_t** shape_data, int* ndim,
                            const char** dtype_name) {
  try {
    PredState* st = state(handle);
    const auto& specs = st->pred->output_specs();
    slot_check(specs, index, "output");
    return get_shape(st, specs[index], shape_data, ndim, dtype_name);
  } catch (const std::exception& e) {
    return fail(e);
  }
}

namespace {

void set_bytes(PredState* st, int index, const void* data,
               uint64_t nbytes) {
  slot_check(st->inputs, index, "input");
  if (data == nullptr) throw std::runtime_error("data is required");
  mxtpu::Tensor& t = st->inputs[index];
  if (nbytes != t.byte_size())
    throw std::runtime_error(
        "input " + std::to_string(index) + " expects " +
        std::to_string(t.byte_size()) + " bytes, got " +
        std::to_string(nbytes));
  t.data.resize(nbytes);
  std::memcpy(t.data.data(), data, nbytes);
  st->input_set[index] = true;
}

}  // namespace

int MXTPUPredSetInput(MXTPUPredictorHandle handle, int index,
                      const float* data, uint64_t size) {
  try {
    PredState* st = state(handle);
    slot_check(st->inputs, index, "input");
    if (st->inputs[index].dtype != mxtpu::DType::kF32)
      throw std::runtime_error(
          "input " + std::to_string(index) + " is " +
          mxtpu::dtype_name(st->inputs[index].dtype) +
          ", not f32: use MXTPUPredSetInputBytes");
    uint64_t want =
        static_cast<uint64_t>(st->inputs[index].num_elements());
    if (size != want)
      throw std::runtime_error(
          "input " + std::to_string(index) + " expects " +
          std::to_string(want) + " f32 elements, got " +
          std::to_string(size));
    set_bytes(st, index, data, size * sizeof(float));
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredSetInputBytes(MXTPUPredictorHandle handle, int index,
                           const void* data, uint64_t nbytes) {
  try {
    set_bytes(state(handle), index, data, nbytes);
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredForward(MXTPUPredictorHandle handle) {
  try {
    PredState* st = state(handle);
    for (size_t i = 0; i < st->input_set.size(); ++i)
      if (!st->input_set[i])
        throw std::runtime_error("input " + std::to_string(i) +
                                 " was never set");
    st->outputs = st->pred->forward(st->inputs);
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

namespace {

const mxtpu::Tensor& output_at(PredState* st, int index) {
  if (st->outputs.empty())
    throw std::runtime_error("no outputs: call MXTPUPredForward first");
  slot_check(st->outputs, index, "output");
  return st->outputs[index];
}

}  // namespace

int MXTPUPredGetOutput(MXTPUPredictorHandle handle, int index, float* data,
                       uint64_t size) {
  try {
    PredState* st = state(handle);
    const mxtpu::Tensor& t = output_at(st, index);
    if (t.dtype != mxtpu::DType::kF32)
      throw std::runtime_error(
          "output " + std::to_string(index) + " is " +
          mxtpu::dtype_name(t.dtype) +
          ", not f32: use MXTPUPredGetOutputBytes");
    if (size != static_cast<uint64_t>(t.num_elements()))
      throw std::runtime_error(
          "output " + std::to_string(index) + " has " +
          std::to_string(t.num_elements()) + " f32 elements, got buffer "
          "for " + std::to_string(size));
    if (data == nullptr) throw std::runtime_error("data is required");
    std::memcpy(data, t.data.data(), t.data.size());
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredGetOutputBytes(MXTPUPredictorHandle handle, int index,
                            void* data, uint64_t nbytes) {
  try {
    PredState* st = state(handle);
    const mxtpu::Tensor& t = output_at(st, index);
    if (nbytes != t.data.size())
      throw std::runtime_error(
          "output " + std::to_string(index) + " is " +
          std::to_string(t.data.size()) + " bytes, got buffer for " +
          std::to_string(nbytes));
    if (data == nullptr) throw std::runtime_error("data is required");
    std::memcpy(data, t.data.data(), nbytes);
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int MXTPUPredFree(MXTPUPredictorHandle handle) {
  try {
    delete state(handle);
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

}  // extern "C"
