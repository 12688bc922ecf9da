// K4a as the C++ op `mxnet_tpu_torch::rnn_fwd` (libmxtpu_torch_ops.so).
//
// An exported word LM keeps K4a as one node of its graph
// (mxnet_tpu_torch/ops/fused_rnn.py registers the op in Python); the
// AOTInductor package of that graph calls the op back by name through its
// proxy executor. This library registers the op in a process that runs
// the package without Python: the same schema string, and
//   - on CUDA tensors, K4a from mxnet_tpu_torch/ops/csrc/fused_rnn.cu
//     through its C entry mxtt_rnn_fwd, at the design `rnn_design` picks
//     (a port of fused_rnn.py rnn_design, which asks the same library for
//     the shared memory and the clusters the card runs at once), counted
//     in mxtpu_rnn_fwd_launches() (every call of the op, on either device,
//     in mxtpu_rnn_fwd_calls()); a layer outside the kernels' limit
//     (fused_rnn.py fused_rnn_limit) raises;
//   - on CPU tensors, a plain scan in ATen with the arithmetic and the
//     rounding points of fused_rnn.py rnn_fwd_plain, op for op.
// Never load this library into a Python process that imported
// mxnet_tpu_torch: fused_rnn.py defines the same namespace there.
#include <ATen/ATen.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <tuple>

#ifdef MXTPU_WITH_CUDA
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int mxtt_rnn_fwd(int dtype, int mode, const void* px,
                            const void* h0, const void* c0, const void* wh,
                            void* ys, void* cs, void* hT, void* cT, int steps,
                            int N, int H, int rows, int P, int reverse,
                            void* stream);
extern "C" long long mxtt_rnn_smem_bytes(int dtype, int mode, int H,
                                         int rows, int P, int bwd);
extern "C" int mxtt_rnn_max_clusters(int dtype, int mode, int H, int rows,
                                     int P, int bwd);
extern "C" const char* mxtt_error_string(int err);
#endif

namespace {

using Outputs = std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor>;

std::atomic<long long> g_launches{0};  // K4a launches (CUDA)
std::atomic<long long> g_calls{0};     // op calls, either device
thread_local std::string g_error;

// fused_rnn.py _GATES / _MODE_CODE
int mode_code(const std::string& mode) {
  if (mode == "lstm") return 0;
  if (mode == "rnn_relu") return 1;
  if (mode == "rnn_tanh") return 2;
  return -1;
}

int gates(int mode) { return mode == 0 ? 4 : 1; }

// fused_rnn.py fused_rnn_limit: "" when the kernels take the layer
std::string limit(const std::string& mode, int64_t T, int64_t N, int64_t H,
                  const std::set<at::ScalarType>& dtypes) {
  if (mode_code(mode) < 0)
    return "mode '" + mode +
           "': the fused kernels take lstm, rnn_relu and rnn_tanh";
  if (T < 1 || N < 1 || H < 1)
    return "empty shape T=" + std::to_string(T) + " N=" + std::to_string(N) +
           " H=" + std::to_string(H);
  if (dtypes.size() != 1)
    return "mixed dtypes: px, the states and wh must share one";
  const at::ScalarType dt = *dtypes.begin();
  if (dt != at::kFloat && dt != at::kBFloat16)
    return std::string("dtype ") + c10::toString(dt) +
           ": the fused kernels take float32 or bfloat16";
  if (H > 1024)
    return "H=" + std::to_string(H) +
           ": the fused kernels take H up to 1024 (a block keeps its rows' "
           "gates in shared memory)";
  if (N >= (int64_t(1) << 31))
    return "N=" + std::to_string(N) + ": the fused kernels take N below 2^31";
  return "";
}

// fused_rnn.py rnn_fwd_plain, op for op
Outputs scan_cpu(const std::string& mode, const at::Tensor& px,
                 const at::Tensor& h0, const std::optional<at::Tensor>& c0,
                 const at::Tensor& wh, bool reverse) {
  const int64_t T = px.size(0), N = px.size(1), H = wh.size(1);
  const at::ScalarType dt = px.scalar_type();
  const bool lstm = mode == "lstm";
  TORCH_CHECK(mode_code(mode) >= 0, "rnn_fwd: mode '", mode,
              "' is not lstm, rnn_relu or rnn_tanh");
  TORCH_CHECK(!lstm || c0.has_value(), "rnn_fwd: lstm needs c0");
  const at::Tensor w = wh.to(at::kFloat);
  at::Tensor h = h0.to(at::kFloat);
  at::Tensor c = lstm ? c0->to(at::kFloat) : at::Tensor();
  at::Tensor ys = at::empty({T, N, H}, px.options());
  at::Tensor cs = lstm ? at::empty_like(ys) : px.new_empty({0});
  for (int64_t s = 0; s < T; ++s) {
    const int64_t t = reverse ? T - 1 - s : s;
    const at::Tensor hin = h.to(dt);
    const at::Tensor pre =
        px.select(0, t).to(at::kFloat) + at::matmul(hin.to(at::kFloat),
                                                    w.t());
    if (lstm) {
      std::vector<at::Tensor> q = at::chunk(pre, 4, -1);
      const at::Tensor i = at::sigmoid(q[0]), f = at::sigmoid(q[1]),
                       g = at::tanh(q[2]), o = at::sigmoid(q[3]);
      c = f * c + i * g;
      h = o * at::tanh(c);
      cs.select(0, t).copy_(c.to(dt));
    } else if (mode == "rnn_relu") {
      h = at::clamp(pre, 0.0, std::nullopt);
    } else {
      h = at::tanh(pre);
    }
    ys.select(0, t).copy_(h.to(dt));
  }
  return {ys, cs, h.to(dt), lstm ? c.to(dt) : px.new_empty({0})};
}

#ifdef MXTPU_WITH_CUDA

// fused_rnn.py's design constants (SMEM_LIMIT, CLUSTER_BLOCKS,
// CLUSTER_ROWS, STREAM_MAX_ROWS, STREAM_MAX_GATE_ROWS, CLUSTER_ELEMS)
constexpr long long kSmemLimit = 232448;
constexpr int kClusterBlocks[] = {16, 8, 4};
constexpr int kClusterRows[] = {8, 16, 32};
constexpr int kStreamMaxRows = 16, kStreamMaxGateRows = 64;
constexpr long long kClusterElems = 2 * 512;

struct Design {
  bool cluster;
  int P;
  int rows;
  long long blocks;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// fused_rnn.py cluster_units
long long cluster_units(int H, int P, int dtype) {
  const int vec = 16 / (dtype == 0 ? 4 : 2);
  return ceil_div(ceil_div(H, P), vec) * vec;
}

// fused_rnn.py batch_tile
int batch_tile(long long N) {
  for (int bn : {1, 2})
    if (ceil_div(N, bn) <= 16) return bn;
  return 4;
}

// fused_rnn.py clusters_at_once: asked once per device and layout
int clusters_at_once(int dtype, int mode, int H, int P, int R) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int>, int> cache;
  const int device = c10::cuda::current_device();
  const auto key = std::make_tuple(device, mode, H, dtype, P, R);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int n = -1;
  for (int bwd : {0, 1}) {
    const int got = mxtt_rnn_max_clusters(dtype, mode, H, R, P, bwd);
    TORCH_CHECK(got >= 0, "fused_rnn cluster occupancy query failed: ",
                mxtt_error_string(-got));
    n = n < 0 ? got : std::min(n, got);
  }
  cache[key] = n;
  return n;
}

// fused_rnn.py rnn_design: the cluster layout with the fewest waves, then
// the fewest rows, then the most blocks; else streaming
Design rnn_design(int mode, long long N, int H, int dtype) {
  bool found = false;
  std::tuple<long long, int, int> best_key;
  Design best{};
  if (N > kStreamMaxRows || gates(mode) * H > kStreamMaxGateRows) {
    std::set<int> rows;
    for (int r : kClusterRows)
      rows.insert(static_cast<int>(std::min<long long>(r, N)));
    for (int P : kClusterBlocks) {
      for (int R : rows) {
        if (R * cluster_units(H, P, dtype) > kClusterElems) continue;
        const long long f = mxtt_rnn_smem_bytes(dtype, mode, H, R, P, 0);
        const long long b = mxtt_rnn_smem_bytes(dtype, mode, H, R, P, 1);
        if (std::max(f, b) > kSmemLimit) continue;
        const int n = clusters_at_once(dtype, mode, H, P, R);
        if (n < 1) continue;  // the card cannot hold one such cluster
        const long long clusters = ceil_div(N, R);
        const auto key = std::make_tuple(ceil_div(clusters, n), R, -P);
        if (!found || key < best_key) {
          found = true;
          best_key = key;
          best = Design{true, P, R, clusters * P};
        }
      }
    }
  }
  if (found) return best;
  const int bn = batch_tile(N);
  return Design{false, 0, bn, ceil_div(N, bn)};
}

Outputs k4a_cuda(c10::string_view mode_view, const at::Tensor& px,
                 const at::Tensor& h0, const std::optional<at::Tensor>& c0,
                 const at::Tensor& wh, bool reverse) {
  ++g_calls;
  const std::string mode(mode_view);
  const bool lstm = mode == "lstm";
  TORCH_CHECK(px.dim() == 3 && wh.dim() == 2, "fused_rnn forward: "
              "sequences must be [T, N, *] and wh [G*H, H], got ",
              px.sizes(), " and ", wh.sizes());
  const int64_t T = px.size(0), N = px.size(1), H = wh.size(1);
  std::set<at::ScalarType> dtypes{px.scalar_type(), h0.scalar_type(),
                                  wh.scalar_type()};
  if (lstm) {
    TORCH_CHECK(c0.has_value(), "fused_rnn forward: lstm needs c0");
    dtypes.insert(c0->scalar_type());
  }
  const std::string why = limit(mode, T, N, H, dtypes);
  TORCH_CHECK(why.empty(), "fused_rnn forward: ", why);
  const int G = gates(mode_code(mode));
  std::vector<std::pair<const char*, const at::Tensor*>> named{
      {"px", &px}, {"h0", &h0}, {"wh", &wh}};
  if (lstm) named.push_back({"c0", &*c0});
  for (const auto& [name, t] : named) {
    const std::vector<int64_t> want =
        std::string(name) == "px"   ? std::vector<int64_t>{T, N, G * H}
        : std::string(name) == "wh" ? std::vector<int64_t>{G * H, H}
                                    : std::vector<int64_t>{N, H};
    TORCH_CHECK(t->sizes().vec() == want, "fused_rnn forward: ", name,
                " is ", t->sizes(), ", expected ", c10::IntArrayRef(want));
    TORCH_CHECK(t->device() == px.device(), "fused_rnn forward: ", name,
                " is on ", t->device(), ", expected ", px.device());
    TORCH_CHECK(t->is_contiguous(), "fused_rnn forward: ", name,
                " must be contiguous");
  }
  c10::cuda::CUDAGuard guard(px.device());
  const int dtype = px.scalar_type() == at::kFloat ? 0 : 1;
  const int mc = mode_code(mode);
  at::Tensor ys = at::empty({T, N, H}, px.options());
  at::Tensor hT = at::empty({N, H}, px.options());
  at::Tensor cs = lstm ? at::empty_like(ys) : px.new_empty({0});
  at::Tensor cT = lstm ? at::empty_like(hT) : px.new_empty({0});
  const Design d = rnn_design(mc, N, static_cast<int>(H), dtype);
  const int err = mxtt_rnn_fwd(
      dtype, mc, px.data_ptr(), h0.data_ptr(),
      lstm ? c0->data_ptr() : nullptr, wh.data_ptr(), ys.data_ptr(),
      lstm ? cs.data_ptr() : nullptr, hT.data_ptr(),
      lstm ? cT.data_ptr() : nullptr, static_cast<int>(T),
      static_cast<int>(N), static_cast<int>(H), d.rows, d.P,
      reverse ? 1 : 0,
      c10::cuda::getCurrentCUDAStream(px.device().index()).stream());
  TORCH_CHECK(err == 0, "fused_rnn forward kernel launch (",
              d.cluster ? "cluster" : "stream", " design) failed: CUDA "
              "error ", err, " (", mxtt_error_string(err), ")");
  ++g_launches;
  return {ys, cs, hT, cT};
}

#endif  // MXTPU_WITH_CUDA

Outputs k4a_cpu(c10::string_view mode, const at::Tensor& px,
                const at::Tensor& h0, const std::optional<at::Tensor>& c0,
                const at::Tensor& wh, bool reverse) {
  ++g_calls;
  return scan_cpu(std::string(mode), px, h0, c0, wh, reverse);
}

}  // namespace

// the schema string of mxnet_tpu_torch/ops/fused_rnn.py (_LIB.define)
TORCH_LIBRARY(mxnet_tpu_torch, m) {
  m.def("rnn_fwd(str mode, Tensor px, Tensor h0, Tensor? c0, Tensor wh, "
        "bool reverse) -> (Tensor, Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(mxnet_tpu_torch, CPU, m) { m.impl("rnn_fwd", k4a_cpu); }

#ifdef MXTPU_WITH_CUDA
TORCH_LIBRARY_IMPL(mxnet_tpu_torch, CUDA, m) {
  m.impl("rnn_fwd", k4a_cuda);
}
#endif

extern "C" long long mxtpu_rnn_fwd_launches(void) { return g_launches; }

extern "C" long long mxtpu_rnn_fwd_calls(void) { return g_calls; }

extern "C" void mxtpu_rnn_fwd_reset_launches(void) {
  g_launches = 0;
  g_calls = 0;
}

extern "C" const char* mxtpu_rnn_last_error(void) { return g_error.c_str(); }

// The design K4a takes for one layer on the current CUDA device: 0 and
// (P, rows, blocks), P = 0 for streaming; -1 (mxtpu_rnn_last_error says
// why) on a build without CUDA or a failed query.
extern "C" int mxtpu_rnn_design(int dtype, int mode, long long N, int H,
                                int* P, int* rows, long long* blocks) {
#ifdef MXTPU_WITH_CUDA
  try {
    const Design d = rnn_design(mode, N, H, dtype);
    *P = d.P;
    *rows = d.rows;
    *blocks = d.blocks;
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
#else
  (void)dtype; (void)mode; (void)N; (void)H; (void)P; (void)rows;
  (void)blocks;
  g_error = "libmxtpu_torch_ops was built without CUDA";
  return -1;
#endif
}
