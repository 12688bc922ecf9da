// mxtpu::Predictor on libtorch: the artifact's AOTInductor package run by
// AOTIModelPackageLoader on the device asked for (see predictor.hpp).
#include "mxtpu/predictor.hpp"

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <stdlib.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <mutex>
#include <sstream>
#include <stdexcept>

namespace mxtpu {

int64_t Tensor::num_elements() const {
  int64_t n = 1;
  for (int64_t d : dims) n *= d;
  return n;
}

size_t dtype_bytes(DType t) {
  switch (t) {
    case DType::kF64: case DType::kS64: return 8;
    case DType::kF32: case DType::kS32: return 4;
    case DType::kF16: case DType::kBF16: return 2;
    default: return 1;
  }
}

const char* dtype_name(DType t) {
  switch (t) {
    case DType::kF32: return "f32";
    case DType::kF16: return "f16";
    case DType::kF64: return "f64";
    case DType::kBF16: return "bf16";
    case DType::kS32: return "s32";
    case DType::kS64: return "s64";
    case DType::kS8: return "s8";
    case DType::kU8: return "u8";
    case DType::kPred: return "pred";
  }
  return "?";
}

namespace {

// ---------------------------------------------------------------------------
// STORE-only zip reader (export_model writes ZIP_STORED; a compressed
// entry is refused, not misread)
// ---------------------------------------------------------------------------

uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }

std::vector<uint8_t> read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open artifact " + path);
  return std::vector<uint8_t>((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
}

// (offset, size) of entry `name`'s bytes, or size_t(-1) offset if absent
std::pair<size_t, size_t> find_entry(const std::vector<uint8_t>& buf,
                                     const std::string& name) {
  if (buf.size() < 22) throw std::runtime_error("artifact too small");
  size_t eocd = std::string::npos;
  for (size_t i = buf.size() - 22;; --i) {
    if (rd32(&buf[i]) == 0x06054b50) { eocd = i; break; }
    if (i == 0) break;
  }
  if (eocd == std::string::npos)
    throw std::runtime_error("not a zip artifact (no end of directory)");
  const uint16_t n_entries = rd16(&buf[eocd + 10]);
  size_t off = rd32(&buf[eocd + 16]);
  for (uint16_t e = 0; e < n_entries; ++e) {
    if (off + 46 > buf.size() || rd32(&buf[off]) != 0x02014b50)
      throw std::runtime_error("corrupt zip central directory");
    const uint16_t method = rd16(&buf[off + 10]);
    const uint32_t csize = rd32(&buf[off + 20]);
    const uint16_t name_len = rd16(&buf[off + 28]);
    const uint16_t extra_len = rd16(&buf[off + 30]);
    const uint16_t comment_len = rd16(&buf[off + 32]);
    const uint32_t local = rd32(&buf[off + 42]);
    if (off + 46 + name_len > buf.size())
      throw std::runtime_error("corrupt zip central directory");
    std::string entry(reinterpret_cast<const char*>(&buf[off + 46]),
                      name_len);
    if (entry == name) {
      if (method != 0)
        throw std::runtime_error("zip entry " + name + " is compressed; "
                                 "artifacts must be STORE-only");
      if (local + 30 > buf.size() || rd32(&buf[local]) != 0x04034b50)
        throw std::runtime_error("corrupt zip local header");
      const size_t data =
          local + 30 + rd16(&buf[local + 26]) + rd16(&buf[local + 28]);
      if (data + csize > buf.size())
        throw std::runtime_error("zip entry " + name + " overruns the file");
      return {data, csize};
    }
    off += 46 + name_len + extra_len + comment_len;
  }
  return {size_t(-1), 0};
}

bool has_entry(const std::vector<uint8_t>& buf, const std::string& name) {
  return find_entry(buf, name).first != size_t(-1);
}

std::string read_entry(const std::vector<uint8_t>& buf,
                       const std::string& name) {
  auto [off, size] = find_entry(buf, name);
  if (off == size_t(-1))
    throw std::runtime_error("artifact has no entry " + name);
  return std::string(reinterpret_cast<const char*>(&buf[off]), size);
}

// ---------------------------------------------------------------------------
// signature.txt
// ---------------------------------------------------------------------------

DType parse_dtype(const std::string& s) {
  if (s == "f32") return DType::kF32;
  if (s == "f16") return DType::kF16;
  if (s == "f64") return DType::kF64;
  if (s == "bf16") return DType::kBF16;
  if (s == "s32") return DType::kS32;
  if (s == "s64") return DType::kS64;
  if (s == "s8") return DType::kS8;
  if (s == "u8") return DType::kU8;
  if (s == "pred") return DType::kPred;
  throw std::runtime_error("signature has unknown dtype " + s);
}

at::ScalarType scalar_type(DType t) {
  switch (t) {
    case DType::kF32: return at::kFloat;
    case DType::kF16: return at::kHalf;
    case DType::kF64: return at::kDouble;
    case DType::kBF16: return at::kBFloat16;
    case DType::kS32: return at::kInt;
    case DType::kS64: return at::kLong;
    case DType::kS8: return at::kChar;
    case DType::kU8: return at::kByte;
    case DType::kPred: return at::kBool;
  }
  return at::kFloat;
}

void parse_signature(const std::string& text, std::vector<Tensor>* ins,
                     std::vector<Tensor>* outs) {
  std::istringstream ss(text);
  std::string line;
  while (std::getline(ss, line)) {
    if (line.empty()) continue;
    std::istringstream ls(line);
    std::string role, dtype, dims;
    ls >> role >> dtype >> dims;
    Tensor t;
    t.dtype = parse_dtype(dtype);
    if (!dims.empty() && dims != "scalar") {
      std::istringstream ds(dims);
      std::string d;
      while (std::getline(ds, d, 'x')) t.dims.push_back(std::stoll(d));
    }
    if (role == "in") ins->push_back(std::move(t));
    else if (role == "out") outs->push_back(std::move(t));
    else throw std::runtime_error("signature has unknown role " + role);
  }
  if (outs->empty())
    throw std::runtime_error("signature declares no outputs");
}

// "cuda:0" / "cuda" / "cpu" -> a device and the artifact's package kind
c10::Device parse_device(const std::string& name, std::string* kind) {
  if (name == "cpu") {
    *kind = "cpu";
    return c10::Device(c10::kCPU);
  }
  if (name == "cuda" || name.rfind("cuda:", 0) == 0) {
    *kind = "cuda";
    int index = 0;
    if (name.size() > 5) {
      char* end = nullptr;
      index = static_cast<int>(std::strtol(name.c_str() + 5, &end, 10));
      if (end == name.c_str() + 5 || *end != '\0' || index < 0)
        throw std::runtime_error("bad device name " + name);
    }
    return c10::Device(c10::kCUDA, static_cast<c10::DeviceIndex>(index));
  }
  throw std::runtime_error("device must be cuda, cuda:<n> or cpu, got " +
                           name);
}

// the package's bytes in a file of their own (the loader takes a path);
// removed once the loader has read it
struct TempFile {
  std::string path;
  explicit TempFile(const uint8_t* data, size_t size) {
    std::string tmpl =
        (std::filesystem::temp_directory_path() / "mxtpu-aoti-XXXXXX.pt2")
            .string();
    std::vector<char> buf(tmpl.begin(), tmpl.end());
    buf.push_back('\0');
    int fd = mkstemps(buf.data(), 4);
    if (fd < 0) throw std::runtime_error("cannot make a temporary file");
    path = buf.data();
    size_t done = 0;
    while (done < size) {
      ssize_t n = ::write(fd, data + done, size - done);
      if (n <= 0) {
        ::close(fd);
        throw std::runtime_error("cannot write " + path);
      }
      done += static_cast<size_t>(n);
    }
    ::close(fd);
  }
  ~TempFile() { std::remove(path.c_str()); }
};

}  // namespace

// ---------------------------------------------------------------------------
// Impl
// ---------------------------------------------------------------------------

struct Predictor::Impl {
  c10::Device device{c10::kCPU};
  std::string platform;
  std::vector<Tensor> input_specs;
  std::vector<Tensor> output_specs;
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  size_t n_state = 0;
  std::vector<Tensor> init_state;
  std::vector<at::Tensor> state;  // on `device` between steps

  at::Tensor upload(const Tensor& t, const Tensor& spec, size_t index) const {
    if (t.dtype != spec.dtype || t.dims != spec.dims ||
        t.data.size() != spec.byte_size())
      throw std::runtime_error(
          "input " + std::to_string(index) + " does not match the artifact "
          "signature (want " + std::string(dtype_name(spec.dtype)) + ")");
    at::Tensor host = at::empty(spec.dims, at::TensorOptions().dtype(
                                               scalar_type(spec.dtype)));
    if (!t.data.empty())
      std::memcpy(host.data_ptr(), t.data.data(), t.data.size());
    return host.to(device);
  }

  static Tensor download(const at::Tensor& value, const Tensor& spec,
                         size_t index) {
    at::Tensor host = value.to(at::kCPU).contiguous();
    if (host.scalar_type() != scalar_type(spec.dtype) ||
        host.sizes().vec() != spec.dims)
      throw std::runtime_error(
          "output " + std::to_string(index) + " is " +
          std::string(c10::toString(host.scalar_type())) + " " +
          c10::str(host.sizes()) + ", the signature says " +
          dtype_name(spec.dtype));
    Tensor t = spec;
    t.data.resize(host.nbytes());
    if (host.nbytes() > 0)
      std::memcpy(t.data.data(), host.data_ptr(), host.nbytes());
    return t;
  }

  std::vector<at::Tensor> run(const std::vector<at::Tensor>& args) {
    std::vector<at::Tensor> outs = loader->run(args);
    if (outs.size() != output_specs.size())
      throw std::runtime_error(
          "the package returned " + std::to_string(outs.size()) +
          " outputs, the signature declares " +
          std::to_string(output_specs.size()));
    return outs;
  }

  void synchronize() const {
    if (device.is_cuda())
      c10::impl::getDeviceGuardImpl(device.type())
          ->synchronizeDevice(device.index());
  }

  std::vector<at::Tensor> stage(const std::vector<Tensor>& inputs) const {
    if (inputs.size() != input_specs.size())
      throw std::runtime_error("expected " +
                               std::to_string(input_specs.size()) +
                               " inputs, got " +
                               std::to_string(inputs.size()));
    std::vector<at::Tensor> args;
    for (size_t i = 0; i < inputs.size(); ++i)
      args.push_back(upload(inputs[i], input_specs[i], i));
    return args;
  }
};

Predictor::Predictor(const std::string& artifact_path,
                     const std::string& device)
    : impl_(new Impl()) {
  Impl& im = *impl_;
  std::string kind;
  im.device = parse_device(device, &kind);
  im.platform = im.device.is_cuda() ? "gpu" : "cpu";
  std::vector<uint8_t> zip = read_file(artifact_path);
  parse_signature(read_entry(zip, "signature.txt"), &im.input_specs,
                  &im.output_specs);
  if (has_entry(zip, "train.txt")) {
    std::istringstream ts(read_entry(zip, "train.txt"));
    std::string word;
    ts >> word >> im.n_state;
    if (word != "n_state" || im.n_state == 0 ||
        im.n_state + 5 != im.input_specs.size() ||
        im.n_state + 1 != im.output_specs.size())
      throw std::runtime_error(
          "train.txt n_state inconsistent with the signature");
    for (size_t i = 0; i < im.n_state; ++i) {
      // output 1+i feeds input i at the next step
      if (im.output_specs[1 + i].dtype != im.input_specs[i].dtype ||
          im.output_specs[1 + i].dims != im.input_specs[i].dims)
        throw std::runtime_error(
            "state " + std::to_string(i) + ": output spec does not match "
            "input spec (broken chain in the artifact signature)");
      Tensor t = im.input_specs[i];
      std::string blob = read_entry(zip, "state/" + std::to_string(i) +
                                             ".bin");
      if (blob.size() != t.byte_size())
        throw std::runtime_error("state blob " + std::to_string(i) +
                                 " size mismatch with signature");
      t.data.assign(blob.begin(), blob.end());
      im.init_state.push_back(std::move(t));
    }
  }
  const std::string entry = "aoti/" + kind + ".pt2";
  auto [off, size] = find_entry(zip, entry);
  if (off == size_t(-1))
    throw std::runtime_error(
        "artifact " + artifact_path + " has no " + entry + ": compile it "
        "for this device with mxnet_tpu_torch.predict.compile_for_cpp(path, "
        "ctx=" + (kind == "cpu" ? "mx.cpu()" : "mx.gpu(0)") + ")");
  // the port's parity rule: float32 products in float32
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  {
    TempFile pkg(&zip[off], size);
    zip.clear();
    zip.shrink_to_fit();
    im.loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        pkg.path, "model", false, 1,
        im.device.is_cuda() ? im.device.index() : -1);
  }
}

Predictor::~Predictor() = default;

const std::vector<Tensor>& Predictor::input_specs() const {
  return impl_->input_specs;
}
const std::vector<Tensor>& Predictor::output_specs() const {
  return impl_->output_specs;
}
const std::string& Predictor::platform() const { return impl_->platform; }

std::vector<Tensor> Predictor::forward(const std::vector<Tensor>& inputs) {
  Impl& im = *impl_;
  c10::InferenceMode guard;
  std::vector<at::Tensor> outs = im.run(im.stage(inputs));
  std::vector<Tensor> host;
  for (size_t i = 0; i < outs.size(); ++i)
    host.push_back(Impl::download(outs[i], im.output_specs[i], i));
  return host;
}

double Predictor::time_forward(const std::vector<Tensor>& inputs,
                               int repeat) {
  Impl& im = *impl_;
  if (repeat < 1) throw std::runtime_error("repeat must be >= 1");
  c10::InferenceMode guard;
  std::vector<at::Tensor> args = im.stage(inputs);
  im.run(args);
  im.synchronize();
  double total = 0;
  for (int i = 0; i < repeat; ++i) {
    auto t0 = std::chrono::steady_clock::now();
    im.run(args);
    im.synchronize();
    total += std::chrono::duration<double, std::milli>(
                 std::chrono::steady_clock::now() - t0).count();
  }
  return total / repeat;
}

// ---------------------------------------------------------------------------
// training artifacts
// ---------------------------------------------------------------------------

bool Predictor::is_train() const { return impl_->n_state > 0; }
size_t Predictor::n_state() const { return impl_->n_state; }

std::vector<Tensor> Predictor::initial_state() const {
  return impl_->init_state;
}

void Predictor::load_state(const std::vector<Tensor>& state) {
  Impl& im = *impl_;
  if (!is_train())
    throw std::runtime_error("load_state: not a training artifact");
  if (state.size() != im.n_state)
    throw std::runtime_error("load_state: expected " +
                             std::to_string(im.n_state) + " tensors, got " +
                             std::to_string(state.size()));
  std::vector<at::Tensor> values;
  for (size_t i = 0; i < state.size(); ++i)
    values.push_back(im.upload(state[i], im.input_specs[i], i));
  im.state = std::move(values);
}

float Predictor::train_step(const std::vector<Tensor>& step_inputs) {
  Impl& im = *impl_;
  if (im.n_state == 0 || im.state.size() != im.n_state)
    throw std::runtime_error("train_step: call load_state first");
  const size_t n_step = im.input_specs.size() - im.n_state;
  if (step_inputs.size() != n_step)
    throw std::runtime_error("train_step: expected " +
                             std::to_string(n_step) + " step inputs, got " +
                             std::to_string(step_inputs.size()));
  const Tensor& seed = step_inputs[2];
  if (seed.dtype != DType::kS32 || seed.data.size() != 4)
    throw std::runtime_error("train_step: seed must be an s32 scalar");
  int32_t seed_value;
  std::memcpy(&seed_value, seed.data.data(), 4);
  c10::InferenceMode guard;
  std::vector<at::Tensor> args(im.state);
  for (size_t i = 0; i < step_inputs.size(); ++i)
    args.push_back(im.upload(step_inputs[i], im.input_specs[im.n_state + i],
                             im.n_state + i));
  {
    at::Generator gen = at::globalContext().defaultGenerator(im.device);
    std::lock_guard<std::mutex> lock(gen.mutex());
    gen.set_current_seed(static_cast<uint64_t>(seed_value));
  }
  std::vector<at::Tensor> outs = im.run(args);
  at::Tensor loss = outs[0].to(at::kCPU);
  if (loss.scalar_type() != at::kFloat || loss.numel() != 1)
    throw std::runtime_error("train artifact loss is not a f32 scalar");
  im.state.assign(outs.begin() + 1, outs.end());
  return loss.item<float>();
}

std::vector<Tensor> Predictor::read_state() {
  Impl& im = *impl_;
  if (im.n_state == 0 || im.state.size() != im.n_state)
    throw std::runtime_error("read_state: call load_state first");
  std::vector<Tensor> out;
  for (size_t i = 0; i < im.state.size(); ++i)
    out.push_back(Impl::download(im.state[i], im.input_specs[i], i));
  return out;
}

}  // namespace mxtpu
