// Native C++ reference implementation of segment argmax / max pooling
// (the port's own copy of the JAX package's native/segment_max.cpp).
//
// Role: a CPU oracle for the node-pooling implementations (SURVEY.md
// §2.2: the reference ships four equivalent index_max implementations,
// CPU single-thread, CPU multi-thread over channels, CUDA, CUDA
// shared-mem (index_max.cpp:154-159), which served as each other's
// correctness checks; this file plays the CPU pair's role).
//
// Semantics (parity with index_max_cuda.cu:66-100):
//   data   : (B, N, C) float32, row-major
//   seg_id : (B, N) int32, values in [0, M)
//   out_idx: (B, M, C) int32 — argmax point index per (node, channel),
//            first-max-wins (strict '>' scan), 0 for empty nodes
//   out_val: (B, M, C) float32 — the max value, data[b,0,c] for empty
//            nodes (the reference's gather-index-0 behavior,
//            networks.py:185)
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kNegInf = -3.0e38f;

void run_range(const float* data, const int32_t* seg_id, int64_t B,
               int64_t N, int64_t C, int64_t M, int32_t* out_idx,
               float* out_val, int64_t b_begin, int64_t b_end) {
  std::vector<float> best_val(static_cast<size_t>(M) * C);
  std::vector<int32_t> best_idx(static_cast<size_t>(M) * C);
  for (int64_t b = b_begin; b < b_end; ++b) {
    std::fill(best_val.begin(), best_val.end(), kNegInf);
    std::fill(best_idx.begin(), best_idx.end(), 0);
    const float* db = data + b * N * C;
    const int32_t* ib = seg_id + b * N;
    for (int64_t n = 0; n < N; ++n) {
      const int32_t m = ib[n];
      if (m < 0 || m >= M) continue;  // padding ids are skipped
      const float* row = db + n * C;
      float* bv = best_val.data() + static_cast<size_t>(m) * C;
      int32_t* bi = best_idx.data() + static_cast<size_t>(m) * C;
      for (int64_t c = 0; c < C; ++c) {
        if (row[c] > bv[c]) {  // strict '>': first max wins
          bv[c] = row[c];
          bi[c] = static_cast<int32_t>(n);
        }
      }
    }
    // empty nodes -> index 0 / value of point 0
    for (int64_t m = 0; m < M; ++m) {
      float* bv = best_val.data() + static_cast<size_t>(m) * C;
      int32_t* bi = best_idx.data() + static_cast<size_t>(m) * C;
      for (int64_t c = 0; c < C; ++c) {
        if (bv[c] == kNegInf) {
          bv[c] = db[c];  // data[b, 0, c]
          bi[c] = 0;
        }
      }
    }
    std::memcpy(out_val + b * M * C, best_val.data(),
                sizeof(float) * M * C);
    std::memcpy(out_idx + b * M * C, best_idx.data(),
                sizeof(int32_t) * M * C);
  }
}

}  // namespace

extern "C" {

// Single-threaded (parity: index_max.cpp forward_cpu).
void segment_argmax_cpu(const float* data, const int32_t* seg_id, int64_t B,
                        int64_t N, int64_t C, int64_t M, int32_t* out_idx,
                        float* out_val) {
  run_range(data, seg_id, B, N, C, M, out_idx, out_val, 0, B);
}

// std::thread pool over the batch (parity: forward_multi_thread_cpu,
// index_max.cpp:50-67, which threads over channels; batch is the natural
// independent axis here).
void segment_argmax_cpu_mt(const float* data, const int32_t* seg_id,
                           int64_t B, int64_t N, int64_t C, int64_t M,
                           int32_t* out_idx, float* out_val,
                           int64_t num_threads) {
  if (num_threads <= 1 || B <= 1) {
    run_range(data, seg_id, B, N, C, M, out_idx, out_val, 0, B);
    return;
  }
  const int64_t T = std::min<int64_t>(num_threads, B);
  std::vector<std::thread> threads;
  const int64_t per = (B + T - 1) / T;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(B, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(run_range, data, seg_id, B, N, C, M, out_idx,
                         out_val, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
