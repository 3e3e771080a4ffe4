// BatchNorm over the trailing channel axis, fused with the bias add before
// it and the activation after it, forward and backward, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's nn/layers.py BatchNorm is left
// to XLA, which fuses the bias add, the statistics, the normalisation and
// the ReLU around the matmul on the TPU.  In PyTorch the same chain ran as
// a dozen separate passes a layer forward and twice as many backward, most
// of them in float32 (about 68 bytes an element forward and 120 backward).
// These kernels run it in the fewest passes the data dependences allow:
//
//   forward   statistics: read y once (twice below 8,192 rows)     2 B/el
//             apply:      read y, write the output                 4 B/el
//   backward  sums:       read the cotangent g and y               4 B/el
//             dy:         read g and y, write dy                   6 B/el
//
// (bf16; twice that in float32), so the chain is bound by the card's 3.35
// TB/s at about 16 bytes an element.  Every operation is a few flops an
// element, far below the card's rate.  Each kernel's time at the main
// path's shapes, beside its bound: PERF.md section 6, kernel table row 3
// (chip_smoke.py phase 3 measures them).
//
// Contract (the wrapper, sonet_torch/ops/cuda/batchnorm_act.py, checks it):
//   y      (R, C) bf16 or float32, channel-last, contiguous, the product of
//          a dense layer before its bias; C a multiple of 8; 16-byte aligned
//   bias   (C) in y's type, or null: h = round_to_type(y + bias) is what
//          the bias add stored before; it is recomputed wherever h is read
//   mean, var, gamma, beta   (C) float32
// Statistics, normalisation and the backward run in float32; the output
// and dy are rounded once to y's type, as the unfused chain rounds them.
// The forward computes ((h - mean) * rsqrt(var + eps)) * gamma + beta with
// a rounding after each operation (no contraction into an FMA), as the
// unfused chain's four float32 operations do, then rounds to y's type and
// applies the ReLU.  The backward recomputes the normalised value, the
// rounded pre-activation and so the ReLU's mask from y: nothing but y and
// the per-channel vectors is saved.
//
// Layout.  A block has 256 threads; thread t covers the 16-byte vector
// (8 bf16 or 4 float32 channels) `lane` = t % tile of rows sub, sub + rpi,
// ... (rpi = 256 / tile), so a warp reads whole rows, neighbouring threads
// on neighbouring addresses.  A row of more than 256 vectors is cut into
// tiles (gridDim.y).  gridDim.x blocks each own a contiguous chunk of rows
// and keep four rows a thread in flight.
//
// Reductions are deterministic: each block sums its rows in a fixed order,
// writes one partial per channel (no atomics), and batchnorm_finish adds
// the partials in a fixed order.  The grid depends only on (R, C, dtype) and
// the card's SM count, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // rows a thread keeps in flight
constexpr int kStatsBlocksPerSm = 2;  // reductions: few partials to finish
constexpr int kApplyBlocksPerSm = 8;  // elementwise passes: one full wave

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float scalar(const float* p) { return *p; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t bits(float x) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 t;
    t.x = bits(v[0]) | (bits(v[1]) << 16);
    t.y = bits(v[2]) | (bits(v[3]) << 16);
    t.z = bits(v[4]) | (bits(v[5]) << 16);
    t.w = bits(v[6]) | (bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = t;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

struct Geometry {
  int rows;   // R
  int lanes;  // 16-byte vectors in a row: C / N
  int tile;   // vectors a block covers (gridDim.y tiles a row)
  int rpi;    // rows a block covers in one step: kThreads / tile
  int chunk;  // rows of one block
  int blocks; // gridDim.x
  int tiles;  // gridDim.y
};

int sm_count(int device) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      n <= 0)
    n = 132;
  if (device >= 0 && device < 64) cached[device] = n;
  return n;
}

Geometry geometry(int R, int C, int dtype, int blocks_per_sm, int device) {
  Geometry g;
  const int N = dtype == 0 ? 4 : 8;
  g.rows = R;
  g.lanes = C / N;
  g.tiles = (g.lanes + kThreads - 1) / kThreads;
  g.tile = (g.lanes + g.tiles - 1) / g.tiles;
  g.rpi = kThreads / g.tile;
  const int per_step = g.rpi * kUnroll;
  const int most = (R + per_step - 1) / per_step;  // >= kUnroll rows a thread
  int want = blocks_per_sm * sm_count(device) / g.tiles;
  if (want < 1) want = 1;
  int blocks = most < want ? most : want;
  if (blocks < 1) blocks = 1;
  g.chunk = (R + blocks - 1) / blocks;
  if (g.chunk < 1) g.chunk = 1;
  g.blocks = (R + g.chunk - 1) / g.chunk;
  if (g.blocks < 1) g.blocks = 1;
  return g;
}

// The value the bias add stored: y + bias rounded to T.
template <typename T>
__device__ __forceinline__ float biased(float y, float b, bool has_bias) {
  return has_bias ? Vec<T>::round(__fadd_rn(y, b)) : y;
}

// ((h - mean) * rstd), one rounding an operation.
__device__ __forceinline__ float normalised(float h, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(h, mean), rstd);
}

// The pre-activation in T: xhat * gamma + beta, rounded to T.
template <typename T>
__device__ __forceinline__ float affine(float xhat, float gamma, float beta) {
  return Vec<T>::round(__fadd_rn(__fmul_rn(xhat, gamma), beta));
}

// Per-thread position: the vector lane of the row and the first row.
struct Position {
  int cv;    // 16-byte vector of the row: channels cv * N ... cv * N + N - 1
  int sub;   // the thread's row within a step
  bool on;   // the thread covers a vector
};

__device__ __forceinline__ Position position(const Geometry& g) {
  Position p;
  const int lane = threadIdx.x % g.tile;
  p.sub = threadIdx.x / g.tile;
  p.cv = blockIdx.y * g.tile + lane;
  p.on = p.sub < g.rpi && lane < g.tile && p.cv < g.lanes;
  return p;
}

// Sums s1, s2 of every thread of the block over its rows, in row order,
// written as this block's partials (blocks, 2, C).  Called by all threads.
template <int N>
__device__ void write_partials(const Geometry& g, const float (&s1)[N],
                               const float (&s2)[N], float* partials) {
  __shared__ float red[2][kThreads * N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    red[0][threadIdx.x * N + j] = s1[j];
    red[1][threadIdx.x * N + j] = s2[j];
  }
  __syncthreads();
  const int C = g.lanes * N;
  const int width = g.tile * N;
  for (int q = threadIdx.x; q < width; q += kThreads) {
    const int c = blockIdx.y * width + q;
    if (c >= C) continue;
    float a = 0.f, b = 0.f;
    for (int s = 0; s < g.rpi; ++s) {
      a += red[0][s * width + q];
      b += red[1][s * width + q];
    }
    partials[(static_cast<size_t>(blockIdx.x) * 2) * C + c] = a;
    partials[(static_cast<size_t>(blockIdx.x) * 2 + 1) * C + c] = b;
  }
}

// Statistics of h: s1 = sum h, s2 = sum h^2 (kCentered: s2 = sum
// (h - center)^2, s1 = 0), as per-block partials.
template <typename T, bool kCentered>
__global__ void __launch_bounds__(kThreads)
    batchnorm_stats(const T* __restrict__ y, const T* __restrict__ bias,
                    const float* __restrict__ center, Geometry g,
                    float* __restrict__ partials) {
  constexpr int N = Vec<T>::N;
  const Position p = position(g);
  const int C = g.lanes * N;
  float s1[N], s2[N], b[N], m[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s1[j] = s2[j] = b[j] = m[j] = 0.f;
  const bool has_bias = bias != nullptr;
  if (p.on) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (has_bias) b[j] = Vec<T>::scalar(bias + p.cv * N + j);
      if (kCentered) m[j] = center[p.cv * N + j];
    }
    const int r0 = blockIdx.x * g.chunk;
    const int r1 = min(g.rows, r0 + g.chunk);
    const T* base = y + static_cast<size_t>(p.cv) * N;
    int r = r0 + p.sub;
    auto add = [&](const float (&v)[N]) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float h = biased<T>(v[j], b[j], has_bias);
        if (kCentered) {
          const float d = __fsub_rn(h, m[j]);
          s2[j] = fmaf(d, d, s2[j]);
        } else {
          s1[j] += h;
          s2[j] = fmaf(h, h, s2[j]);
        }
      }
    };
    for (; r + (kUnroll - 1) * g.rpi < r1; r += kUnroll * g.rpi) {
      float v[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Vec<T>::load(base + static_cast<size_t>(r + u * g.rpi) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(v[u]);
    }
    for (; r < r1; r += g.rpi) {
      float v[N];
      Vec<T>::load(base + static_cast<size_t>(r) * C, v);
      add(v);
    }
  }
  write_partials<N>(g, s1, s2, partials);
}

// Adds the partials (blocks, 2, C) in a fixed order: the warp w of a block
// of 1,024 threads sums blocks w, w + 32, ... for 32 neighbouring channels
// (one 128-byte row segment a load), then the 32 warps' sums are added in
// warp order.  Its time is the latency of a few dependent loads.  n > 0:
// writes out0 = s1 / n (the mean) and out1 = s2 / n - mean^2 (the one-pass
// variance), or, centered, out1 = s2 / n (the two-pass variance) only;
// n == 0: the raw sums, out0 = s1 (unless centered) and out1 = s2.
constexpr int kFinishThreads = 1024;
constexpr int kFinishLanes = 32;
constexpr int kFinishGroups = kFinishThreads / kFinishLanes;

__global__ void __launch_bounds__(kFinishThreads)
    batchnorm_finish(const float* __restrict__ partials, int blocks, int C,
                     float n, int centered, float* __restrict__ out0,
                     float* __restrict__ out1) {
  const int lane = threadIdx.x % kFinishLanes;
  const int group = threadIdx.x / kFinishLanes;
  const int c = blockIdx.x * kFinishLanes + lane;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int i = group; i < blocks; i += kFinishGroups) {
      s1 += partials[(static_cast<size_t>(i) * 2) * C + c];
      s2 += partials[(static_cast<size_t>(i) * 2 + 1) * C + c];
    }
  }
  __shared__ float red[2][kFinishGroups][kFinishLanes];
  red[0][group][lane] = s1;
  red[1][group][lane] = s2;
  __syncthreads();
  if (group != 0 || c >= C) return;
  s1 = s2 = 0.f;
#pragma unroll
  for (int g = 0; g < kFinishGroups; ++g) {
    s1 += red[0][g][lane];
    s2 += red[1][g][lane];
  }
  if (n == 0.f) {
    if (!centered) out0[c] = s1;
    out1[c] = s2;
  } else if (centered) {
    out1[c] = __fdiv_rn(s2, n);
  } else {
    const float mean = __fdiv_rn(s1, n);
    out0[c] = mean;
    out1[c] = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  }
}

// out = act(round_T(((h - mean) * rsqrt(var + eps)) * gamma + beta)).
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    batchnorm_apply(const T* __restrict__ y, const T* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float eps, Geometry g,
                    T* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  const Position p = position(g);
  if (!p.on) return;
  const int C = g.lanes * N;
  const bool has_bias = bias != nullptr;
  float b[N], m[N], rs[N], ga[N], be[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = p.cv * N + j;
    b[j] = has_bias ? Vec<T>::scalar(bias + c) : 0.f;
    m[j] = mean[c];
    rs[j] = rsqrtf(__fadd_rn(var[c], eps));
    ga[j] = gamma[c];
    be[j] = beta[c];
  }
  const int r0 = blockIdx.x * g.chunk;
  const int r1 = min(g.rows, r0 + g.chunk);
  const size_t off = static_cast<size_t>(p.cv) * N;
  auto one = [&](float (&v)[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float z = affine<T>(normalised(biased<T>(v[j], b[j], has_bias), m[j],
                                     rs[j]),
                          ga[j], be[j]);
      if (kRelu) z = z <= 0.f ? 0.f : z;  // NaN passes, as torch's relu
      v[j] = z;
    }
  };
  int r = r0 + p.sub;
  for (; r + (kUnroll - 1) * g.rpi < r1; r += kUnroll * g.rpi) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      Vec<T>::load(y + static_cast<size_t>(r + u * g.rpi) * C + off, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      one(v[u]);
      Vec<T>::store(out + static_cast<size_t>(r + u * g.rpi) * C + off, v[u]);
    }
  }
  for (; r < r1; r += g.rpi) {
    float v[N];
    Vec<T>::load(y + static_cast<size_t>(r) * C + off, v);
    one(v);
    Vec<T>::store(out + static_cast<size_t>(r) * C + off, v);
  }
}

// Per-channel values the backward kernels recompute the forward from.
template <typename T, int N>
struct Channel {
  float b[N], m[N], rs[N], ga[N], be[N];
  __device__ __forceinline__ void load(int cv, const T* bias,
                                       const float* mean, const float* var,
                                       const float* gamma, const float* beta,
                                       float eps) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = cv * N + j;
      b[j] = bias != nullptr ? Vec<T>::scalar(bias + c) : 0.f;
      m[j] = mean[c];
      rs[j] = rsqrtf(__fadd_rn(var[c], eps));
      ga[j] = gamma[c];
      be[j] = beta[c];
    }
  }
};

// The cotangent of the normalised value's affine map (the ReLU's mask
// applied) and the normalised value itself, for channel j.
template <typename T, bool kRelu, int N>
__device__ __forceinline__ void masked(const Channel<T, N>& ch, int j,
                                       float yv, float gv, bool has_bias,
                                       float* gz, float* xhat) {
  *xhat = normalised(biased<T>(yv, ch.b[j], has_bias), ch.m[j], ch.rs[j]);
  *gz = gv;
  if (kRelu && affine<T>(*xhat, ch.ga[j], ch.be[j]) <= 0.f) *gz = 0.f;
}

// Per-block partials of s1 = sum gz (d beta) and s2 = sum gz * xhat
// (d gamma).
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    batchnorm_backward_sums(const T* __restrict__ g_out,
                            const T* __restrict__ y,
                            const T* __restrict__ bias,
                            const float* __restrict__ mean,
                            const float* __restrict__ var,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, float eps,
                            Geometry g, float* __restrict__ partials) {
  constexpr int N = Vec<T>::N;
  const Position p = position(g);
  const int C = g.lanes * N;
  const bool has_bias = bias != nullptr;
  float s1[N], s2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s1[j] = s2[j] = 0.f;
  if (p.on) {
    Channel<T, N> ch;
    ch.load(p.cv, bias, mean, var, gamma, beta, eps);
    const int r0 = blockIdx.x * g.chunk;
    const int r1 = min(g.rows, r0 + g.chunk);
    const size_t off = static_cast<size_t>(p.cv) * N;
    auto add = [&](const float (&yv)[N], const float (&gv)[N]) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float gz, xhat;
        masked<T, kRelu, N>(ch, j, yv[j], gv[j], has_bias, &gz, &xhat);
        s1[j] += gz;
        s2[j] = fmaf(gz, xhat, s2[j]);
      }
    };
    int r = r0 + p.sub;
    for (; r + (kUnroll - 1) * g.rpi < r1; r += kUnroll * g.rpi) {
      float yv[kUnroll][N], gv[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t at = static_cast<size_t>(r + u * g.rpi) * C + off;
        Vec<T>::load(y + at, yv[u]);
        Vec<T>::load(g_out + at, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(yv[u], gv[u]);
    }
    for (; r < r1; r += g.rpi) {
      float yv[N], gv[N];
      const size_t at = static_cast<size_t>(r) * C + off;
      Vec<T>::load(y + at, yv);
      Vec<T>::load(g_out + at, gv);
      add(yv, gv);
    }
  }
  write_partials<N>(g, s1, s2, partials);
}

// kTrain: dy = gamma * rstd * (gz - (sum_gz + xhat * sum_gzx) / n), with
// the sums over every row of the batch (of the whole mesh);
// else (running statistics): dy = gamma * rstd * gz.  Rounded to T.
template <typename T, bool kRelu, bool kTrain>
__global__ void __launch_bounds__(kThreads)
    batchnorm_backward_dx(const T* __restrict__ g_out,
                          const T* __restrict__ y, const T* __restrict__ bias,
                          const float* __restrict__ mean,
                          const float* __restrict__ var,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps,
                          const float* __restrict__ sum_gz,
                          const float* __restrict__ sum_gzx, float n,
                          Geometry g, T* __restrict__ dy) {
  constexpr int N = Vec<T>::N;
  const Position p = position(g);
  if (!p.on) return;
  const int C = g.lanes * N;
  const bool has_bias = bias != nullptr;
  Channel<T, N> ch;
  ch.load(p.cv, bias, mean, var, gamma, beta, eps);
  float k[N], a[N], bx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = p.cv * N + j;
    k[j] = __fmul_rn(ch.ga[j], ch.rs[j]);
    a[j] = kTrain ? __fdiv_rn(sum_gz[c], n) : 0.f;
    bx[j] = kTrain ? __fdiv_rn(sum_gzx[c], n) : 0.f;
  }
  const int r0 = blockIdx.x * g.chunk;
  const int r1 = min(g.rows, r0 + g.chunk);
  const size_t off = static_cast<size_t>(p.cv) * N;
  auto one = [&](const float (&yv)[N], float (&gv)[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float gz, xhat;
      masked<T, kRelu, N>(ch, j, yv[j], gv[j], has_bias, &gz, &xhat);
      const float d = kTrain ? gz - fmaf(xhat, bx[j], a[j]) : gz;
      gv[j] = d * k[j];
    }
  };
  int r = r0 + p.sub;
  for (; r + (kUnroll - 1) * g.rpi < r1; r += kUnroll * g.rpi) {
    float yv[kUnroll][N], gv[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t at = static_cast<size_t>(r + u * g.rpi) * C + off;
      Vec<T>::load(y + at, yv[u]);
      Vec<T>::load(g_out + at, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      one(yv[u], gv[u]);
      Vec<T>::store(dy + static_cast<size_t>(r + u * g.rpi) * C + off, gv[u]);
    }
  }
  for (; r < r1; r += g.rpi) {
    float yv[N], gv[N];
    const size_t at = static_cast<size_t>(r) * C + off;
    Vec<T>::load(y + at, yv);
    Vec<T>::load(g_out + at, gv);
    one(yv, gv);
    Vec<T>::store(dy + at, gv);
  }
}

// Switches to `device` for the launches and back.
struct OnDevice {
  int previous = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&previous);
    if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  }
  ~OnDevice() {
    int now = -1;
    if (cudaGetDevice(&now) == cudaSuccess && now != previous && previous >= 0)
      cudaSetDevice(previous);
  }
};

bool bad_shape(int dtype, int R, int C) {
  return (dtype != 0 && dtype != 1) || R < 1 || C < 8 || C % 8 != 0;
}

dim3 grid_of(const Geometry& g) {
  return dim3(static_cast<unsigned>(g.blocks), static_cast<unsigned>(g.tiles));
}

template <typename T>
cudaError_t stats_launch(const void* y, const void* bias, const float* center,
                         const Geometry& g, float* partials, cudaStream_t s) {
  const T* yt = static_cast<const T*>(y);
  const T* bt = static_cast<const T*>(bias);
  if (center != nullptr)
    batchnorm_stats<T, true><<<grid_of(g), kThreads, 0, s>>>(yt, bt, center, g,
                                                             partials);
  else
    batchnorm_stats<T, false><<<grid_of(g), kThreads, 0, s>>>(yt, bt, nullptr,
                                                              g, partials);
  return cudaGetLastError();
}

cudaError_t finish_launch(const float* partials, const Geometry& g, int C,
                          float n, bool centered, float* out0, float* out1,
                          cudaStream_t s) {
  batchnorm_finish<<<(C + kFinishLanes - 1) / kFinishLanes, kFinishThreads, 0,
                     s>>>(partials, g.blocks, C, n, centered ? 1 : 0, out0,
                          out1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_launch(const void* y, const void* bias, const float* mean,
                         const float* var, const float* gamma,
                         const float* beta, float eps, int relu,
                         const Geometry& g, void* out, cudaStream_t s) {
  const T* yt = static_cast<const T*>(y);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (relu)
    batchnorm_apply<T, true><<<grid_of(g), kThreads, 0, s>>>(
        yt, bt, mean, var, gamma, beta, eps, g, ot);
  else
    batchnorm_apply<T, false><<<grid_of(g), kThreads, 0, s>>>(
        yt, bt, mean, var, gamma, beta, eps, g, ot);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_sums_launch(const void* g_out, const void* y,
                                 const void* bias, const float* mean,
                                 const float* var, const float* gamma,
                                 const float* beta, float eps, int relu,
                                 const Geometry& g, float* partials,
                                 cudaStream_t s) {
  const T* gt = static_cast<const T*>(g_out);
  const T* yt = static_cast<const T*>(y);
  const T* bt = static_cast<const T*>(bias);
  if (relu)
    batchnorm_backward_sums<T, true><<<grid_of(g), kThreads, 0, s>>>(
        gt, yt, bt, mean, var, gamma, beta, eps, g, partials);
  else
    batchnorm_backward_sums<T, false><<<grid_of(g), kThreads, 0, s>>>(
        gt, yt, bt, mean, var, gamma, beta, eps, g, partials);
  return cudaGetLastError();
}

template <typename T, bool kTrain>
cudaError_t backward_dx_launch(const void* g_out, const void* y,
                               const void* bias, const float* mean,
                               const float* var, const float* gamma,
                               const float* beta, float eps, int relu,
                               const float* sum_gz, const float* sum_gzx,
                               float n, const Geometry& g, void* dy,
                               cudaStream_t s) {
  const T* gt = static_cast<const T*>(g_out);
  const T* yt = static_cast<const T*>(y);
  const T* bt = static_cast<const T*>(bias);
  T* dt = static_cast<T*>(dy);
  if (relu)
    batchnorm_backward_dx<T, true, kTrain><<<grid_of(g), kThreads, 0, s>>>(
        gt, yt, bt, mean, var, gamma, beta, eps, sum_gz, sum_gzx, n, g, dt);
  else
    batchnorm_backward_dx<T, false, kTrain><<<grid_of(g), kThreads, 0, s>>>(
        gt, yt, bt, mean, var, gamma, beta, eps, sum_gz, sum_gzx, n, g, dt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every function below launches on the
// given device and stream, allocates nothing and returns the cudaError_t of
// its launches (0 = success).  The reductions take a workspace `partials`
// of sonet_batchnorm_partials(...) x 2 x C floats.

// Blocks of the reductions for (R, C, dtype) on `device`: the rows of the
// partials workspace.
extern "C" int sonet_batchnorm_partials(int R, int C, int dtype, int device) {
  if (bad_shape(dtype, R, C)) return -1;
  return geometry(R, C, dtype, kStatsBlocksPerSm, device).blocks;
}

// Statistics of h = round(y + bias) (bias may be null).  center null: n > 0
// writes the mean to out0 and the one-pass variance to out1; n == 0 writes
// sum h and sum h^2.  center given: out1 = sum (h - center)^2, divided by n
// when n > 0 (the two-pass variance); out0 is not written.
extern "C" int sonet_batchnorm_stats(const void* y, int dtype, const void* bias,
                                     int R, int C, const float* center,
                                     float* partials, float n, float* out0,
                                     float* out1, int device, void* stream) {
  if (bad_shape(dtype, R, C)) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(R, C, dtype, kStatsBlocksPerSm, device);
  cudaError_t err =
      dtype == 0 ? stats_launch<float>(y, bias, center, g, partials, s)
                 : stats_launch<__nv_bfloat16>(y, bias, center, g, partials, s);
  if (err == cudaSuccess)
    err = finish_launch(partials, g, C, n, center != nullptr, out0, out1, s);
  return static_cast<int>(err);
}

// out = act(round(((h - mean) * rsqrt(var + eps)) * gamma + beta)); relu
// 1: ReLU, 0: identity.
extern "C" int sonet_batchnorm_apply(const void* y, int dtype, const void* bias,
                                     int R, int C, const float* mean,
                                     const float* var, const float* gamma,
                                     const float* beta, float eps, int relu,
                                     void* out, int device, void* stream) {
  if (bad_shape(dtype, R, C)) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(R, C, dtype, kApplyBlocksPerSm, device);
  const cudaError_t err =
      dtype == 0 ? apply_launch<float>(y, bias, mean, var, gamma, beta, eps,
                                       relu, g, out, s)
                 : apply_launch<__nv_bfloat16>(y, bias, mean, var, gamma, beta,
                                               eps, relu, g, out, s);
  return static_cast<int>(err);
}

// sum_gz = sum of the masked cotangent gz (d beta), sum_gzx = sum of
// gz * xhat (d gamma), over the R rows.
extern "C" int sonet_batchnorm_backward_sums(
    const void* g_out, const void* y, int dtype, const void* bias, int R,
    int C, const float* mean, const float* var, const float* gamma,
    const float* beta, float eps, int relu, float* partials, float* sum_gz,
    float* sum_gzx, int device, void* stream) {
  if (bad_shape(dtype, R, C)) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(R, C, dtype, kStatsBlocksPerSm, device);
  cudaError_t err =
      dtype == 0
          ? backward_sums_launch<float>(g_out, y, bias, mean, var, gamma, beta,
                                        eps, relu, g, partials, s)
          : backward_sums_launch<__nv_bfloat16>(g_out, y, bias, mean, var,
                                                gamma, beta, eps, relu, g,
                                                partials, s);
  if (err == cudaSuccess)
    err = finish_launch(partials, g, C, 0.f, false, sum_gz, sum_gzx, s);
  return static_cast<int>(err);
}

// dy from the cotangent g_out.  n > 0: batch statistics over n rows, with
// the sums of sonet_batchnorm_backward_sums (over every rank); n == 0:
// running statistics (the sums are not read).
extern "C" int sonet_batchnorm_backward_dx(
    const void* g_out, const void* y, int dtype, const void* bias, int R,
    int C, const float* mean, const float* var, const float* gamma,
    const float* beta, float eps, int relu, const float* sum_gz,
    const float* sum_gzx, float n, void* dy, int device, void* stream) {
  if (bad_shape(dtype, R, C)) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(R, C, dtype, kApplyBlocksPerSm, device);
  cudaError_t err;
  if (dtype == 0)
    err = n > 0.f ? backward_dx_launch<float, true>(
                        g_out, y, bias, mean, var, gamma, beta, eps, relu,
                        sum_gz, sum_gzx, n, g, dy, s)
                  : backward_dx_launch<float, false>(
                        g_out, y, bias, mean, var, gamma, beta, eps, relu,
                        sum_gz, sum_gzx, n, g, dy, s);
  else
    err = n > 0.f ? backward_dx_launch<__nv_bfloat16, true>(
                        g_out, y, bias, mean, var, gamma, beta, eps, relu,
                        sum_gz, sum_gzx, n, g, dy, s)
                  : backward_dx_launch<__nv_bfloat16, false>(
                        g_out, y, bias, mean, var, gamma, beta, eps, relu,
                        sum_gz, sum_gzx, n, g, dy, s);
  return static_cast<int>(err);
}
