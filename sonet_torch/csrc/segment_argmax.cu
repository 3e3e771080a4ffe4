// Segment argmax for node pooling, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/segment_argmax.py:segment_argmax of
// the JAX package (the Pallas call at :113).  Same contract:
//   data    (B, N, C) f32, contiguous
//   seg_ids (B, N) int32 node id per point
//   out     (B, M, C) int32: out[b, m, c] = the lowest n with
//           seg_ids[b, n] == m whose data[b, n, c] is the node's maximum;
//           0 where node m is empty or none of its values exceeds -3e38.
// Correct for any ids (sorted or not); ids outside [0, M) are ignored.
// The two zeros tie, as -0.0 == +0.0 does in the TPU kernel.  NaN inputs
// are not defined.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// at (8, 15000, 384) f32, M = 64, the kernel must read 184.3 MB of data
// and 0.48 MB of ids and write 0.79 MB of indices, 185.6 MB in all:
// about 55 us.  Its 46 M comparisons take under a microsecond at the f32
// rate, so it is memory-bound.
//
// Design: the TPU kernel walks the points in order and keeps the running
// (value, index) of every node in VMEM across its sequential grid.  Here
// blocks run in parallel and in no order, so the merge across blocks has
// to be order-free.  A block owns ROWS consecutive points of one cloud and
// a tile of channels; thread t owns channels VEC*t .. VEC*t+VEC-1 (one
// float2 load for VEC = 2, so a warp reads a contiguous row segment).
// Each thread scans its rows with a strict '>' (the first maximum wins
// within the run), keeps the running (value, index) for the current id,
// and merges it into a per-(b, m, c) 64-bit key with one atomicMax when
// the id changes and at the chunk's end.  The key orders "larger value
// first, then lower index": an order-preserving image of the value in the
// high 32 bits, ~index in the low 32 bits.  So the merge is first-max-wins
// whatever order the blocks finish in, and the result is deterministic.
// A last pass turns the keys into int32 indices, 0 where no value won.
// With node-sorted ids a chunk spans one or two nodes, so there are about
// (chunks + nodes) * C atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;     // points per block
constexpr int UNROLL = 8;    // rows loaded before they are compared
constexpr float FLOOR = -3.0e38f;

// A float -> uint32 map that keeps order: a larger float gives a larger
// key.  -0.0 becomes +0.0 first, so the two zeros tie.
__device__ __forceinline__ uint32_t ordered(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (value, index) -> a key whose unsigned order is "larger value first,
// then lower index".  A value above -3e38 gives a high half above 0, so
// key 0 means "no winner".
__device__ __forceinline__ unsigned long long pack(float v, int n) {
  return (static_cast<unsigned long long>(ordered(v)) << 32) |
         static_cast<unsigned long long>(~static_cast<uint32_t>(n));
}

template <int VEC>
struct Loader;

template <>
struct Loader<1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct Loader<2> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
};

__global__ void clear_keys(unsigned long long* __restrict__ keys, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = 0ull;
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            int* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    out[i] = k == 0ull ? 0
                       : static_cast<int>(~static_cast<uint32_t>(k & 0xffffffffull));
  }
}

// grid: (channel tiles, point chunks, B); block: channel groups of VEC
template <int VEC>
__global__ void segment_argmax_keys(const float* __restrict__ data,
                                    const int* __restrict__ ids,
                                    unsigned long long* __restrict__ keys,
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
  const float* src = data + (static_cast<int64_t>(b) * N + n0) * C + c;
  unsigned long long* dst = keys + static_cast<int64_t>(b) * M * C + c;

  float best[VEC];
  int arg[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    best[j] = FLOOR;
    arg[j] = -1;
  }
  int cur = s_ids[0];

  auto flush = [&]() {
    if (cur >= 0 && cur < M) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (arg[j] >= 0) {
          atomicMax(dst + static_cast<int64_t>(cur) * C + j,
                    pack(best[j], arg[j]));
        }
      }
    }
  };

  for (int i0 = 0; i0 < rows; i0 += UNROLL) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u < rows) {
        Loader<VEC>::load(src + static_cast<int64_t>(i0 + u) * C, v[u]);
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
          for (int j = 0; j < VEC; ++j) {
            best[j] = FLOOR;
            arg[j] = -1;
          }
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (v[u][j] > best[j]) {      // strict: the first maximum stays
            best[j] = v[u][j];
            arg[j] = n0 + i0 + u;
          }
        }
      }
    }
  }
  flush();
}

template <int VEC>
cudaError_t launch(const float* data, const int* ids,
                   unsigned long long* keys, int B, int N, int C, int M,
                   cudaStream_t stream) {
  const int groups = (C + VEC - 1) / VEC;
  const int threads = groups < 256 ? ((groups + 31) / 32) * 32 : 256;
  const dim3 grid((groups + threads - 1) / threads, (N + ROWS - 1) / ROWS, B);
  segment_argmax_keys<VEC><<<grid, threads, 0, stream>>>(data, ids, keys, N,
                                                        C, M);
  return cudaGetLastError();
}

}  // namespace

// keys: (B, M, C) 64-bit scratch; out: (B, M, C) int32.  Clears the keys,
// merges every point into them, then unpacks them into out.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int sonet_segment_argmax(const float* data, const int* ids,
                                    unsigned long long* keys, int* out,
                                    int B, int N, int C, int M,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(B) * M * C;
  if (n_out == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_out + 255) / 256);
  clear_keys<<<blocks, 256, 0, s>>>(keys, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0) {
    // channel pairs need an even C and a base address aligned to the pair
    const bool pairs =
        (C % 2) == 0 && reinterpret_cast<uintptr_t>(data) % 8 == 0;
    err = pairs ? launch<2>(data, ids, keys, B, N, C, M, s)
                : launch<1>(data, ids, keys, B, N, C, M, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unpack_keys<<<blocks, 256, 0, s>>>(keys, out, n_out);
  return static_cast<int>(cudaGetLastError());
}
