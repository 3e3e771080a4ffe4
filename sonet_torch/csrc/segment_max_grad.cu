// Node pooling's backward, for NVIDIA Hopper (sm_90a): the gradient of a
// segment max with respect to its input, route_max_grad in
// sonet_torch/ops/segment.py.
//
// Replaces no Pallas kernel.  On the TPU the JAX package routes this
// gradient through one-hot products on the MXU (sonet_tpu/ops/segment.py,
// route_max_grad: the winners' mask from a one-hot product with the
// maxima, the tie counts as a one-hot product with the mask, the ratio
// routed back by a third).  The port carried that over to cuBLAS: two bf16
// one-hot products, a float32 FFMA product for the tie counts and four
// full-size elementwise passes.  Same contract as route_max_grad:
//   data    (B, N, C) bf16 or f32, contiguous
//   ids     (B, N) int32 node id per point; any order, any value
//   out     (B, M, C) the forward's maxima, in data's type
//   counts  (B, M) f32, int32 or int64 node occupancy; 0 = empty node
//   g       (B, M, C) bf16 or f32 cotangent of out
//   point0  (B,) int32 or int64, or null: the row that empty nodes copied
//   grad    (B, N, C) in data's type:
//     ties[b, m, c] = #{n : ids[b, n] == m, data[b, n, c] == out[b, m, c]}
//     ratio         = (counts[b, m] == 0 ? 0 : float(g)) / max(ties, 1),
//                     divided in f32 (IEEE) and rounded to data's type
//     grad[b, n, c] = (0 <= id < M && data == out[b, id, c]) ? ratio : 0
//   and on the row point0[b] (default 0) the empty nodes' cotangent, summed
//   in f32 and rounded to data's type, is added in data's type.  These are
//   route_max_grad's rounding points: the result equals it bit for bit but
//   on that row, whose sum over the empty nodes runs in another order.
//
// Bound on the H100 (3.35 TB/s): at the flagship (8, 15000, 384) bf16,
// M = 64, the function must read data (92.2 MB), ids (0.48 MB), out and g
// (0.39 MB each) and write grad (92.2 MB): 185.6 MB, 0.0554 ms.  It does a
// compare an element, so it is bound by memory at every shape.
//
// Design.  The tie counts are a sum over a whole node, which the routing
// needs before it writes a row, so the work takes two launches:
// - pool_grad_ties reads data once, compares each element with its node's
//   maximum, adds the winners into a zeroed int32 (B, M, C) table and
//   writes the winners as a mask of one byte a thread a row (a bit a
//   channel: 5.8 MB at the flagship, 1/16 of data);
// - pool_grad_route reads the mask, which the L2 (50 MB) still holds, and
//   the ids, and writes grad: never data again.
// So the card moves data once and grad once, the bound's bytes, plus the
// mask through the L2 and the small tables.  Between the launches the
// wrapper may sum the table over a mesh's points ranks.
// Both launch one wave of blocks (as many as fit on the card at once) of G
// row groups of up to 128 threads.  A row group walks one contiguous range
// of the B * N rows (an equal share; it may cross clouds), each thread one
// 16-byte vector of the row (8 bf16 or 4 f32 channels; one channel where
// the width or the alignment does not allow it), UNROLL rows and their ids
// loaded before any is used.  A thread keeps its node's maximum (ties) or
// ratio (route) for its channels in registers until the (cloud, id)
// changes: once or twice a range with node-sorted ids.  The tie counts of
// the current node are integers in registers, flushed by one atomicAdd a
// channel where the node changes and at the range's end, and only where
// not zero (a node's winners are few); integer sums are exact in any
// order, so the table is the same every run.  Ids outside [0, M) count
// nothing and route zero.  The launches run on the caller's stream,
// allocate nothing and can be captured in a graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;         // rows loaded before they are used
constexpr int MAX_THREADS = 128;  // a block's threads at most
constexpr int MAX_GROUPS = 32;    // a block's row groups at most
constexpr int MIN_ROWS = 16;      // a row group's rows at least
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (to nearest, ties to even), as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// VEC channels of T, packed as they lie in memory: one 16-byte load or
// store where VEC * sizeof(T) is 16, else VEC of one channel.  Loads
// stream (evict first): data is read once, and the L2 keeps the mask.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) == 16 ? 16 : alignof(T)) Pack {
  T e[VEC];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(e) =
          __ldcs(reinterpret_cast<const uint4*>(p));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = __ldcs(p + j);
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) p[j] = e[j];
    }
  }
};

// The layout both kernels share.  grid: (blocks, channel tiles); block: G
// row groups of CT threads, each a vector of VEC channels; W vectors a row
// (the mask's bytes a row).  Row group gi of groups walks the rows
// [gi * R / groups, (gi + 1) * R / groups) of the R = B * N rows.
struct Layout {
  int N, C, M;
  int64_t R;   // rows
  int W;       // vectors a row
  int CT;      // vectors a channel tile
  int G;       // row groups a block
  int groups;  // row groups in all: gridDim.x * G
};

struct Range {
  int64_t r0, r1;  // the group's rows
  int w;           // the thread's vector
  bool active;     // rows to walk and a vector to own
};

__device__ __forceinline__ Range range_of(const Layout& L) {
  const int g = threadIdx.x / L.CT;
  const int64_t gi = static_cast<int64_t>(blockIdx.x) * L.G + g;
  Range t;
  t.w = blockIdx.y * L.CT + threadIdx.x % L.CT;
  t.r0 = gi * L.R / L.groups;
  t.r1 = (gi + 1) * L.R / L.groups;
  t.active = g < L.G && t.w < L.W && t.r0 < t.r1;
  return t;
}

// VEC values a thread, passed to and returned from the functions below by
// value (in registers).  Those functions run once a node change or once a
// cloud, so they are not inlined: inlined, each of the UNROLL unrolled rows
// of every instantiation held a copy, nvcc took 48 s for this file instead
// of 9, and the routing kernel ran a third slower.
template <typename V, int VEC>
struct Lanes {
  V v[VEC];
};

// Adds a node's tie counts to its row of the table: only those not zero.
template <int VEC>
__device__ __noinline__ void flush_ties(int* dst, Lanes<int, VEC> cnt) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (cnt.v[j] != 0) atomicAdd(dst + j, cnt.v[j]);
  }
}

__device__ __forceinline__ bool is_empty(const void* counts, int code,
                                         int64_t i) {
  if (code == 0) return static_cast<const float*>(counts)[i] == 0.0f;
  if (code == 1) return static_cast<const int*>(counts)[i] == 0;
  return static_cast<const int64_t*>(counts)[i] == 0;
}

// A node's ratio for VEC channels from at = (node * C + first channel):
// its cotangent (0 for an empty node) over its tie count, at least 1,
// divided in f32 (IEEE) and rounded once to data's type.
template <typename T, typename TG, int VEC>
__device__ __noinline__ Pack<T, VEC> node_ratio(const int* ties,
                                                const void* counts,
                                                int counts_code, const TG* g,
                                                int64_t node, int64_t at) {
  const bool empty = is_empty(counts, counts_code, node);
  Pack<T, VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float gv = empty ? 0.0f : to_f32(g[at + j]);
    r.e[j] = from_f32<T>(gv / static_cast<float>(max(ties[at + j], 1)));
  }
  return r;
}

// The empty nodes' cotangent for VEC channels of a cloud, summed in f32
// over its M nodes from node0.
template <typename TG, int VEC>
__device__ __noinline__ Lanes<float, VEC> empty_sum(const void* counts,
                                                    int counts_code,
                                                    const TG* g, int64_t node0,
                                                    int M, int C, int c0) {
  Lanes<float, VEC> acc;
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc.v[j] = 0.0f;
  for (int m = 0; m < M; ++m) {
    const bool empty = is_empty(counts, counts_code, node0 + m);
    const TG* gm = g + (node0 + m) * C + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc.v[j] += empty ? to_f32(gm[j]) : 0.0f;
  }
  return acc;
}

template <typename T, int VEC>
__global__ void pool_grad_ties(const T* __restrict__ data,
                               const int* __restrict__ ids,
                               const T* __restrict__ out,
                               int* __restrict__ ties,
                               uint8_t* __restrict__ mask, Layout L) {
  const Range t = range_of(L);
  if (!t.active) return;
  const int c0 = t.w * VEC;

  int cur = -1;         // the id whose counts run; -1 is outside [0, M)
  bool inside = false;  // cur in [0, M)
  int64_t node0 = 0;    // its cloud's first node
  int64_t bound = 0;    // the first row of the next cloud
  float o[VEC];
  Lanes<int, VEC> cnt;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    o[j] = 0.0f;
    cnt.v[j] = 0;
  }
  auto flush = [&]() {
    if (inside) flush_ties<VEC>(ties + (node0 + cur) * L.C + c0, cnt);
  };

  for (int64_t r = t.r0; r < t.r1; r += UNROLL) {
    Pack<T, VEC> v[UNROLL];
    int id[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u < t.r1) {
        v[u].load(data + (r + u) * L.C + c0);
        id[u] = ids[r + u];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t row = r + u;
      if (row >= t.r1) break;
      if (id[u] != cur || row >= bound) {
        flush();
        if (row >= bound) {
          const int64_t b = row / L.N;
          node0 = b * L.M;
          bound = (b + 1) * L.N;
        }
        cur = id[u];
        inside = cur >= 0 && cur < L.M;
        if (inside) {
          const T* m = out + (node0 + cur) * L.C + c0;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            o[j] = to_f32(m[j]);
            cnt.v[j] = 0;
          }
        }
      }
      uint32_t bits = 0;
      if (inside) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const bool win = to_f32(v[u].e[j]) == o[j];
          cnt.v[j] += win;
          bits |= static_cast<uint32_t>(win) << j;
        }
      }
      mask[row * L.W + t.w] = static_cast<uint8_t>(bits);
    }
  }
  flush();
}

template <typename T, typename TG, int VEC>
__global__ void pool_grad_route(const uint8_t* __restrict__ mask,
                                const int* __restrict__ ids,
                                const int* __restrict__ ties,
                                const void* __restrict__ counts,
                                int counts_code, const TG* __restrict__ g,
                                const void* __restrict__ point0,
                                int point0_code, T* __restrict__ grad,
                                Layout L) {
  const Range t = range_of(L);
  if (!t.active) return;
  const int c0 = t.w * VEC;

  int cur = -1;         // the id whose ratio is held; -1 is outside [0, M)
  bool inside = false;  // cur in [0, M)
  int64_t node0 = 0;    // its cloud's first node
  int64_t bound = 0;    // the first row of the next cloud
  int64_t p0 = -1;      // the row that takes the empty nodes' cotangent
  Pack<T, VEC> ratio;   // in data's type
  const T zero = from_f32<T>(0.0f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) ratio.e[j] = zero;

  for (int64_t r = t.r0; r < t.r1; r += UNROLL) {
    uint32_t bits[UNROLL];
    int id[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u < t.r1) {
        bits[u] = mask[(r + u) * L.W + t.w];
        id[u] = ids[r + u];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t row = r + u;
      if (row >= t.r1) break;
      if (id[u] != cur || row >= bound) {
        if (row >= bound) {
          const int64_t b = row / L.N;
          node0 = b * L.M;
          bound = (b + 1) * L.N;
          p0 = b * L.N;
          if (point0 != nullptr) {
            p0 += point0_code == 0 ? static_cast<const int*>(point0)[b]
                                   : static_cast<const int64_t*>(point0)[b];
          }
        }
        cur = id[u];
        inside = cur >= 0 && cur < L.M;
        if (inside) {
          ratio = node_ratio<T, TG, VEC>(ties, counts, counts_code, g,
                                         node0 + cur,
                                         (node0 + cur) * L.C + c0);
        }
      }
      Pack<T, VEC> w;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        w.e[j] = inside && (bits[u] >> j & 1u) ? ratio.e[j] : zero;
      }
      if (row == p0) {
        // the empty nodes forwarded this row: their cotangent comes here
        const Lanes<float, VEC> acc = empty_sum<TG, VEC>(
            counts, counts_code, g, node0, L.M, L.C, c0);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          w.e[j] = from_f32<T>(to_f32(w.e[j]) + round_to<T>(acc.v[j]));
        }
      }
      w.store(grad + row * L.C + c0);
    }
  }
}

// Channels a thread: 16 bytes where the row and the address allow it,
// else one.
template <typename T>
int vec_of(const void* data, int C) {
  constexpr int VEC16 = 16 / static_cast<int>(sizeof(T));
  return C % VEC16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0
             ? VEC16
             : 1;
}

// The layout and grid of kernel with VEC channels a thread: one wave of as
// many blocks as fit on the device at once, fewer where a row group would
// get under MIN_ROWS rows.
template <typename Kernel>
cudaError_t make_layout(Kernel kernel, int B, int N, int C, int M, int VEC,
                        int device, Layout* L, dim3* grid, int* threads) {
  static int sm_count[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  L->N = N;
  L->C = C;
  L->M = M;
  L->R = static_cast<int64_t>(B) * N;
  L->W = C / VEC;
  L->CT = L->W < MAX_THREADS ? L->W : MAX_THREADS;
  L->G = MAX_THREADS / L->CT < MAX_GROUPS ? MAX_THREADS / L->CT : MAX_GROUPS;
  *threads = L->G * L->CT;
  const int64_t tiles = (L->W + L->CT - 1) / L->CT;
  if (tiles > 65535) return cudaErrorInvalidValue;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      *threads, 0);
  if (err != cudaSuccess) return err;
  int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) *
                   sm_count[device] / tiles;
  const int64_t most = (L->R / MIN_ROWS + L->G - 1) / L->G;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  L->groups = static_cast<int>(blocks) * L->G;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_ties(const void* data, const int* ids, const void* out,
                        int* ties, uint8_t* mask, int B, int N, int C, int M,
                        int device, cudaStream_t s) {
  constexpr int VEC16 = 16 / static_cast<int>(sizeof(T));
  const int vec = vec_of<T>(data, C);
  const T* d = static_cast<const T*>(data);
  const T* o = static_cast<const T*>(out);
  Layout L;
  dim3 grid;
  int threads;
  cudaError_t err;
  if (vec == VEC16) {
    err = make_layout(pool_grad_ties<T, VEC16>, B, N, C, M, vec, device, &L,
                      &grid, &threads);
    if (err != cudaSuccess) return err;
    pool_grad_ties<T, VEC16><<<grid, threads, 0, s>>>(d, ids, o, ties, mask,
                                                       L);
  } else {
    err = make_layout(pool_grad_ties<T, 1>, B, N, C, M, vec, device, &L,
                      &grid, &threads);
    if (err != cudaSuccess) return err;
    pool_grad_ties<T, 1><<<grid, threads, 0, s>>>(d, ids, o, ties, mask, L);
  }
  return cudaGetLastError();
}

template <typename T, typename TG>
cudaError_t launch_route(const void* data, const uint8_t* mask,
                         const int* ids, const int* ties, const void* counts,
                         int counts_code, const void* g, const void* point0,
                         int point0_code, void* grad, int B, int N, int C,
                         int M, int device, cudaStream_t s) {
  constexpr int VEC16 = 16 / static_cast<int>(sizeof(T));
  // the mask's layout is the one pool_grad_ties wrote for data
  const int vec = vec_of<T>(data, C);
  if (vec == VEC16 && reinterpret_cast<uintptr_t>(grad) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const TG* gg = static_cast<const TG*>(g);
  T* out_grad = static_cast<T*>(grad);
  Layout L;
  dim3 grid;
  int threads;
  cudaError_t err;
  if (vec == VEC16) {
    err = make_layout(pool_grad_route<T, TG, VEC16>, B, N, C, M, vec, device,
                      &L, &grid, &threads);
    if (err != cudaSuccess) return err;
    pool_grad_route<T, TG, VEC16><<<grid, threads, 0, s>>>(
        mask, ids, ties, counts, counts_code, gg, point0, point0_code,
        out_grad, L);
  } else {
    err = make_layout(pool_grad_route<T, TG, 1>, B, N, C, M, vec, device, &L,
                      &grid, &threads);
    if (err != cudaSuccess) return err;
    pool_grad_route<T, TG, 1><<<grid, threads, 0, s>>>(
        mask, ids, ties, counts, counts_code, gg, point0, point0_code,
        out_grad, L);
  }
  return cudaGetLastError();
}

// Runs fn on device, switching to it and back if it is not the current one.
template <typename F>
int on_device(int device, F fn) {
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fn();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

}  // namespace

// The mask's bytes a row for data with rows of C channels: C / 8 (bf16)
// or C / 4 (f32) where a thread takes 16 bytes of the row, else C.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int sonet_pool_grad_mask_width(const void* data, int dtype,
                                          int C) {
  return C / (dtype == 0 ? vec_of<float>(data, C)
                         : vec_of<__nv_bfloat16>(data, C));
}

// dtype: 0 = float32, 1 = bfloat16.  Adds the tie counts of data against
// out into ties, a zeroed int32 (B, M, C) table, and writes the winners'
// mask, (B * N, sonet_pool_grad_mask_width) bytes, on the given device
// and stream.  Returns the cudaError_t of the launch (0 = success).
extern "C" int sonet_pool_grad_ties(const void* data, int dtype,
                                    const int* ids, const void* out,
                                    int* ties, uint8_t* mask, int B, int N,
                                    int C, int M, int device, void* stream) {
  if (static_cast<int64_t>(B) * N * C == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dtype == 0 ? launch_ties<float>(data, ids, out, ties, mask, B, N,
                                           C, M, device, s)
                      : launch_ties<__nv_bfloat16>(data, ids, out, ties, mask,
                                                   B, N, C, M, device, s);
  });
}

// dtype, g_dtype: 0 = float32, 1 = bfloat16.  counts_code: 0 = float32,
// 1 = int32, 2 = int64.  point0_code: 0 = int32, 1 = int64; point0 may be
// null (row 0).  Writes grad (B, N, C) in data's type from the tie counts
// and the mask of sonet_pool_grad_ties on the same data (data itself is
// not read), on the given device and stream.  Returns the cudaError_t of
// the launch (0 = success).
extern "C" int sonet_pool_grad_route(const void* data, int dtype,
                                     const uint8_t* mask, const int* ids,
                                     const int* ties, const void* counts,
                                     int counts_code, const void* g,
                                     int g_dtype, const void* point0,
                                     int point0_code, void* grad, int B,
                                     int N, int C, int M, int device,
                                     void* stream) {
  if (static_cast<int64_t>(B) * N * C == 0) return 0;
  if ((dtype != 0 && dtype != 1) || (g_dtype != 0 && g_dtype != 1) ||
      counts_code < 0 || counts_code > 2 || point0_code < 0 ||
      point0_code > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (dtype == 0) {
      return g_dtype == 0
                 ? launch_route<float, float>(data, mask, ids, ties, counts,
                                              counts_code, g, point0,
                                              point0_code, grad, B, N, C, M,
                                              device, s)
                 : launch_route<float, __nv_bfloat16>(
                       data, mask, ids, ties, counts, counts_code, g, point0,
                       point0_code, grad, B, N, C, M, device, s);
    }
    return g_dtype == 0
               ? launch_route<__nv_bfloat16, float>(
                     data, mask, ids, ties, counts, counts_code, g, point0,
                     point0_code, grad, B, N, C, M, device, s)
               : launch_route<__nv_bfloat16, __nv_bfloat16>(
                     data, mask, ids, ties, counts, counts_code, g, point0,
                     point0_code, grad, B, N, C, M, device, s);
  });
}
