// Windowed segment max for node pooling, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/segment_max_window.py:windowed_vals
// of the JAX package (the Pallas call at :127).  Same contract:
//   data    (B, N, C) bf16 or f32, contiguous
//   seg_ids (B, N) int32 node id per point
//   out     (B, M, C) f32: out[b, m, c] = max of data[b, n, c] over the
//           points n with seg_ids[b, n] == m; -3e38 where node m is empty.
// Correct for any ids (sorted or not); ids outside [0, M) are ignored.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// at the flagship (8, 15000, 384) bf16, M = 64, the kernel must read
// 92.2 MB of data and 0.48 MB of ids and write 0.79 MB, 93.4 MB in all:
// about 28 us.  It does 46 M max operations, well under a microsecond at
// the f32 rate, so it is memory-bound.
//
// Design against that bound: every data byte is read exactly once, with
// neighbouring threads on neighbouring addresses (thread t owns channels
// 2t and 2t+1 and loads them as one __nv_bfloat162 or float2, so a warp
// reads 128 or 256 contiguous bytes of a row).  A block owns ROWS
// consecutive points of one cloud and one tile of channels; it stages the
// chunk's ids in shared memory, and each thread walks the rows UNROLL at
// a time (UNROLL loads in flight before any is used), keeping a running
// max for the current id.  When the id changes, and at the chunk's end,
// it flushes the running max into out with a float atomic max.  With the
// encoder's node-sorted ids a chunk spans one or two nodes, so there are
// about (chunks + nodes) * C atomics (~0.9 M at flagship shapes, ~4% of
// the bytes); unsorted ids stay correct, only slower.  A max does not
// depend on order, so the result is exact and deterministic.  Later work:
// TMA loads, and a per-node design over the offsets the node counts give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;     // points per block
constexpr int UNROLL = 8;    // rows loaded before they are reduced
constexpr float EMPTY = -3.0e38f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  // Sign trick: for v >= 0 the int bit patterns order like the floats;
  // for v < 0 the unsigned bit patterns order in reverse.  -0.0 becomes
  // +0.0 first, or the int path would see INT_MIN and lose it.
  if (v == 0.0f) v = 0.0f;
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct Loader<float, 2> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Loader<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 f = __bfloat1622float2(x);
    v[0] = f.x;
    v[1] = f.y;
  }
};

__global__ void fill_empty(float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = EMPTY;
}

// grid: (channel tiles, point chunks, B); block: channel groups of VEC
template <typename T, int VEC>
__global__ void segment_max_window(const T* __restrict__ data,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out,
                                   int N, int C, int M) {
  __shared__ int s_ids[ROWS];
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, N - n0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s_ids[i] = ids[static_cast<int64_t>(b) * N + n0 + i];
  }
  __syncthreads();

  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c >= C) return;
  const T* src = data + (static_cast<int64_t>(b) * N + n0) * C + c;
  float* dst = out + static_cast<int64_t>(b) * M * C + c;

  float run[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) run[j] = neg_inf();
  int cur = s_ids[0];

  auto flush = [&]() {
    if (cur >= 0 && cur < M) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        atomic_max_f32(dst + static_cast<int64_t>(cur) * C + j, run[j]);
      }
    }
  };

  for (int i0 = 0; i0 < rows; i0 += UNROLL) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u < rows) {
        Loader<T, VEC>::load(src + static_cast<int64_t>(i0 + u) * C, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u < rows) {
        const int id = s_ids[i0 + u];
        if (id != cur) {
          flush();
          cur = id;
#pragma unroll
          for (int j = 0; j < VEC; ++j) run[j] = neg_inf();
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) run[j] = fmaxf(run[j], v[u][j]);
      }
    }
  }
  flush();
}

template <typename T, int VEC>
cudaError_t launch(const void* data, const int* ids, float* out, int B, int N,
                   int C, int M, cudaStream_t stream) {
  const int groups = (C + VEC - 1) / VEC;
  const int threads = groups < 256 ? ((groups + 31) / 32) * 32 : 256;
  const dim3 grid((groups + threads - 1) / threads, (N + ROWS - 1) / ROWS, B);
  segment_max_window<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(data), ids, out, N, C, M);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Fills out with -3e38, then reduces.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int sonet_segment_max_window(const void* data, int dtype,
                                        const int* ids, float* out, int B,
                                        int N, int C, int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(B) * M * C;
  if (n_out == 0) return 0;
  fill_empty<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, s>>>(out,
                                                                        n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return static_cast<int>(err);
  // channel pairs need an even C and a base address aligned to the pair
  const uintptr_t pair_bytes = dtype == 0 ? 8 : 4;
  const bool pairs =
      (C % 2) == 0 && reinterpret_cast<uintptr_t>(data) % pair_bytes == 0;
  if (dtype == 0) {
    err = pairs ? launch<float, 2>(data, ids, out, B, N, C, M, s)
                : launch<float, 1>(data, ids, out, B, N, C, M, s);
  } else if (dtype == 1) {
    err = pairs ? launch<__nv_bfloat16, 2>(data, ids, out, B, N, C, M, s)
                : launch<__nv_bfloat16, 1>(data, ids, out, B, N, C, M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
