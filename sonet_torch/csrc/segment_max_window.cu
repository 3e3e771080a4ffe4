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
// 27.9 us.  It does 46 M max operations, well under a microsecond at the
// f32 rate, so it is memory-bound; so is every other shape.
//
// Two kernels compute the same function, chosen by the shape and the
// alignment of data alone (bulk_path below; the wrapper's kernel_path
// states the same rule):
//
// "bulk": a row of 256 to 2048 bytes that is a multiple of 16 bytes, from
// a base address aligned to 16 bytes (the flagship: 768 bytes in bf16,
// 1536 in f32).  The (B, N, C) array is read as one stream of B*N rows,
// cut into tiles of R rows (about 24 KB; a tile may cross clouds).
// Two persistent blocks a multiprocessor (DEFAULT_CONFIG) each own one
// contiguous range of tiles, so there is one wave and no tail.  In a
// block, one elected thread of a producer warp keeps a ring of four
// tiles in dynamic shared memory full with 1-D bulk asynchronous copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes), the tile's ids beside
// its rows; each stage has a "full" mbarrier that the copies complete and
// an "empty" mbarrier on which every consumer warp arrives once it has
// read the stage.  So 4 x 24 KB a block are in flight or in use at any
// time, spending no registers and no dependent waits on them.  Each
// consumer thread owns one 4-byte word of the row (two bf16 channels or
// one f32 channel: a warp reads 128 consecutive bytes of shared memory,
// free of bank conflicts), walks the rows of every tile of its block and
// keeps the running max of the current (cloud, id) in registers, in f32.
// It flushes with a float atomic max only where the id or the cloud
// changes and at the end of the block's range, never at a tile's end:
// about (blocks + B*M) * C atomics with node-sorted ids.  Unsorted ids
// flush more often and stay exact.
//
// "direct": every other input (an odd C, rows under 256 or over 2048
// bytes, an unaligned view).  A block owns ROWS consecutive points of one
// cloud and a tile of channels; each thread loads its channel group
// straight from global memory, 16 bytes at a time where the row and the
// base allow it and the row has at least 32 such groups, else a channel
// pair (8 or 4 bytes), else one channel, LOADS_IN_FLIGHT channels in
// flight, and flushes as above at every id change and at the chunk's end.
//
// Both start from out filled with -3e38 by fill_empty, launched before
// them on the same stream.  A max does not depend on order, so the result
// is exact and deterministic for both.
//
// Measured on an "NVIDIA H100 80GB HBM3, 700.00 W" (chip_smoke.py phase 3:
// a CUDA graph of 20 calls replayed, fill included, node-sorted ids): the
// bulk kernel takes 0.039 ms at (8, 15000, 384) bf16, 72% of the 0.0279 ms
// bound (the fill 0.0014 ms of it, the main kernel 0.035 ms); 0.067 ms in
// f32 (83% of 0.0554 ms); 0.259 ms at B = 64 in bf16 (86% of 0.2231 ms).
// The direct kernel with channel pairs, which these inputs took before the
// bulk kernel was written, read 0.079, 0.068 and 0.507 ms on them
// (tools/torch_kernel1_probe.py): its 4-byte loads and its chain of waits
// made bf16 rows cost as much as f32 rows.  Ring settings from 2 stages of
// 24 KB to 6 of 12 KB, 1 or 2 blocks a multiprocessor, all read 0.037 to
// 0.040 ms at B = 8; what is left at B = 8 is the ramp of a 36 us kernel
// (14 tiles a block) and the uneven split of 3,750 tiles over 264 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EMPTY = -3.0e38f;

// direct kernel
constexpr int ROWS = 64;             // points per block
constexpr int LOADS_IN_FLIGHT = 16;  // channels loaded before they are reduced

// bulk kernel
constexpr int BULK_MIN_ROW_BYTES = 256;
constexpr int BULK_MAX_ROW_BYTES = 2048;
constexpr int BULK_UNROLL = 8;       // rows read from a stage before reducing
constexpr int MAX_STAGES = 16;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

struct BulkConfig {
  int stages;         // tiles in a block's ring
  int stage_bytes;    // most bytes of rows in a tile
  int blocks_per_sm;  // persistent blocks a multiprocessor
};
constexpr BulkConfig DEFAULT_CONFIG = {4, 24576, 2};
BulkConfig g_config = DEFAULT_CONFIG;

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

// The channels of one 4-byte word of a row, as f32.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int CH = 1;
  __device__ __forceinline__ static void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int CH = 2;
  __device__ __forceinline__ static void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};

__global__ void fill_empty(float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = EMPTY;
}

// ---------------------------------------------------------------------------
// bulk kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.  A
// wait that lasts seconds is a fault in the ring: it traps, so the launch
// ends with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t spins = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023u) == 0) {
      const long long now = clock64();
      if (t0 == 0) t0 = now;
      if (now - t0 > 4000000000LL) __trap();
    }
  }
}

// 1-D bulk asynchronous copy, global to shared; its bytes complete on bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// grid: persistent blocks; block: round_up(W, 32) consumer threads, then
// one producer warp.  W = 4-byte words a row, R = rows a tile (a multiple
// of 4), S = stages.  Dynamic shared memory: S tiles of R * W words, S
// id tiles of R ints, then S full and S empty mbarriers.
template <typename T>
__global__ void segment_max_window_bulk(const uint32_t* __restrict__ data,
                                        const int* __restrict__ ids,
                                        float* __restrict__ out,
                                        int total_rows, int N, int C, int M,
                                        int W, int R, int S) {
  constexpr int CH = Word<T>::CH;
  extern __shared__ __align__(128) unsigned char smem[];
  const int num_tiles = (total_rows + R - 1) / R;
  const int tile0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) *
                                     num_tiles / gridDim.x);
  const int tile1 = static_cast<int>(
      (static_cast<int64_t>(blockIdx.x) + 1) * num_tiles / gridDim.x);
  if (tile0 >= tile1) return;  // more blocks than tiles: before any barrier

  const int stage_words = R * W;
  uint32_t* s_data = reinterpret_cast<uint32_t*>(smem);
  int* s_ids = reinterpret_cast<int*>(s_data + static_cast<size_t>(S) *
                                                   stage_words);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_ids + S * R);
  const uint32_t full0 = shared_addr(s_bar);
  const uint32_t empty0 = shared_addr(s_bar + S);
  const int consumers = static_cast<int>(blockDim.x) - 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrive
      mbar_init(empty0 + 8 * s, consumers / 32);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= consumers) {
    // Producer: one thread refills each stage once its readers have
    // left it.  Its first pass over the ring finds every stage empty.
    if (static_cast<int>(threadIdx.x) == consumers) {
      int s = 0;
      uint32_t parity = 1;
      for (int tile = tile0; tile < tile1; ++tile) {
        mbar_wait(empty0 + 8 * s, parity);
        const int r0 = tile * R;
        const int rows = min(R, total_rows - r0);
        const uint32_t data_bytes = static_cast<uint32_t>(rows) * W * 4u;
        const uint32_t id_bytes = static_cast<uint32_t>(rows) * 4u;
        const int* id_src = ids + r0;
        // a bulk copy takes multiples of 16 bytes from an aligned address:
        // the last tile's ids, or an unaligned ids view, go by plain loads
        const bool ids_bulk =
            id_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(id_src) % 16 == 0;
        if (!ids_bulk) {
          for (int i = 0; i < rows; ++i) s_ids[s * R + i] = id_src[i];
        }
        mbar_arrive_expect_tx(full0 + 8 * s,
                              data_bytes + (ids_bulk ? id_bytes : 0u));
        bulk_copy(shared_addr(s_data + static_cast<size_t>(s) * stage_words),
                  data + static_cast<int64_t>(r0) * W, data_bytes,
                  full0 + 8 * s);
        if (ids_bulk) {
          bulk_copy(shared_addr(s_ids + s * R), id_src, id_bytes,
                    full0 + 8 * s);
        }
        if (++s == S) {
          s = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // Consumers.  Threads past the row's last word read its last word again
  // and flush nothing: they only keep their warp's arrivals whole.
  const bool active = static_cast<int>(threadIdx.x) < W;
  const int w = active ? static_cast<int>(threadIdx.x) : W - 1;
  float run[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) run[j] = neg_inf();
  int cur = -1;             // the id whose max is running; -1 flushes nothing
  int b = tile0 * R / N;    // its cloud
  int bound = (b + 1) * N;  // first row of the next cloud

  auto flush = [&]() {
    if (active && cur >= 0 && cur < M) {
      float* dst = out + (static_cast<int64_t>(b) * M + cur) * C + w * CH;
#pragma unroll
      for (int j = 0; j < CH; ++j) atomic_max_f32(dst + j, run[j]);
    }
  };
  auto step = [&](int row, int id, uint32_t word) {
    if (id != cur || row >= bound) {
      flush();
      if (row >= bound) {
        b = row / N;
        bound = (b + 1) * N;
      }
      cur = id;
#pragma unroll
      for (int j = 0; j < CH; ++j) run[j] = neg_inf();
    }
    float v[CH];
    Word<T>::unpack(word, v);
#pragma unroll
    for (int j = 0; j < CH; ++j) run[j] = fmaxf(run[j], v[j]);
  };

  int s = 0;
  uint32_t parity = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    mbar_wait(full0 + 8 * s, parity);
    const int r0 = tile * R;
    const int rows = min(R, total_rows - r0);
    const uint32_t* sd = s_data + static_cast<size_t>(s) * stage_words + w;
    const int* si = s_ids + s * R;
    int i0 = 0;
    for (; i0 + BULK_UNROLL <= rows; i0 += BULK_UNROLL) {
      uint32_t word[BULK_UNROLL];
      int id[BULK_UNROLL];
#pragma unroll
      for (int u = 0; u < BULK_UNROLL; ++u) {
        word[u] = sd[(i0 + u) * W];
        id[u] = si[i0 + u];
      }
      bool same = r0 + i0 + BULK_UNROLL - 1 < bound;
#pragma unroll
      for (int u = 0; u < BULK_UNROLL; ++u) same = same && id[u] == cur;
      if (same) {  // the usual case with sorted ids: no id to look at
#pragma unroll
        for (int u = 0; u < BULK_UNROLL; ++u) {
          float v[CH];
          Word<T>::unpack(word[u], v);
#pragma unroll
          for (int j = 0; j < CH; ++j) run[j] = fmaxf(run[j], v[j]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < BULK_UNROLL; ++u) {
          step(r0 + i0 + u, id[u], word[u]);
        }
      }
    }
    for (; i0 < rows; ++i0) step(r0 + i0, si[i0], sd[i0 * W]);
    // every lane's reads of the stage come before the warp's arrival, and
    // the arrival before the copy that refills the stage
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == S) {
      s = 0;
      parity ^= 1;
    }
  }
  flush();
}

// True if data takes the bulk kernel: by the row's bytes and the base
// address alone.
bool bulk_path(const void* data, int64_t row_bytes) {
  return row_bytes % 16 == 0 && row_bytes >= BULK_MIN_ROW_BYTES &&
         row_bytes <= BULK_MAX_ROW_BYTES &&
         reinterpret_cast<uintptr_t>(data) % 16 == 0;
}

template <typename T>
cudaError_t launch_bulk(const void* data, const int* ids, float* out,
                        int64_t total_rows, int N, int C, int M, int device,
                        cudaStream_t stream) {
  static int sm_count[MAX_DEVICES] = {};
  static int smem_allowed[MAX_DEVICES] = {};
  const BulkConfig cfg = g_config;
  const int row_bytes = C * static_cast<int>(sizeof(T));
  const int W = row_bytes / 4;
  int R = cfg.stage_bytes / row_bytes;
  R = R >= 8 ? R / 8 * 8 : R / 4 * 4;
  const int S = cfg.stages;
  if (R < 4 || S < 1 || S > MAX_STAGES || cfg.blocks_per_sm < 1) {
    return cudaErrorInvalidValue;
  }
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const int slot = device;
  cudaError_t err;
  if (sm_count[slot] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[slot],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int smem = S * (R * row_bytes + R * 4) + 2 * S * 8;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > smem_allowed[slot]) {
    err = cudaFuncSetAttribute(segment_max_window_bulk<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(segment_max_window_bulk<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_allowed[slot] = smem;
  }
  const int64_t num_tiles = (total_rows + R - 1) / R;
  const int64_t resident =
      static_cast<int64_t>(sm_count[slot]) * cfg.blocks_per_sm;
  const int blocks = static_cast<int>(num_tiles < resident ? num_tiles
                                                           : resident);
  const int threads = (W + 31) / 32 * 32 + 32;
  segment_max_window_bulk<T><<<blocks, threads, smem, stream>>>(
      static_cast<const uint32_t*>(data), ids, out,
      static_cast<int>(total_rows), N, C, M, W, R, S);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// direct kernel
// ---------------------------------------------------------------------------

// VEC channels from p as f32: 16, 8 or 4 bytes in one load, or one bf16.
template <typename T, int VEC>
__device__ __forceinline__ void load_channels(const T* p, float* v) {
  constexpr int BYTES = VEC * static_cast<int>(sizeof(T));
  constexpr int CH = Word<T>::CH;
  if constexpr (BYTES == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    Word<T>::unpack(x.x, v);
    Word<T>::unpack(x.y, v + CH);
    Word<T>::unpack(x.z, v + 2 * CH);
    Word<T>::unpack(x.w, v + 3 * CH);
  } else if constexpr (BYTES == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    Word<T>::unpack(x.x, v);
    Word<T>::unpack(x.y, v + CH);
  } else if constexpr (BYTES == 4) {
    Word<T>::unpack(__ldg(reinterpret_cast<const uint32_t*>(p)), v);
  } else {
    static_assert(BYTES == 2, "one bf16 channel");
    v[0] = __uint_as_float(
        static_cast<uint32_t>(__ldg(reinterpret_cast<const uint16_t*>(p)))
        << 16);
  }
}

// grid: (cloud * point chunks, channel tiles); block: channel groups of VEC
template <typename T, int VEC>
__global__ void segment_max_window_direct(const T* __restrict__ data,
                                          const int* __restrict__ ids,
                                          float* __restrict__ out, int N,
                                          int C, int M, int chunks) {
  constexpr int UNROLL = LOADS_IN_FLIGHT / VEC >= 8 ? 8 : LOADS_IN_FLIGHT / VEC;
  __shared__ int s_ids[ROWS];
  const int b = blockIdx.x / chunks;
  const int n0 = (blockIdx.x - b * chunks) * ROWS;
  const int rows = min(ROWS, N - n0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s_ids[i] = ids[static_cast<int64_t>(b) * N + n0 + i];
  }
  __syncthreads();

  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
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
        load_channels<T, VEC>(src + static_cast<int64_t>(i0 + u) * C, v[u]);
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
cudaError_t launch_direct(const void* data, const int* ids, float* out, int B,
                          int N, int C, int M, cudaStream_t stream) {
  const int groups = (C + VEC - 1) / VEC;
  const int threads = groups < 256 ? ((groups + 31) / 32) * 32 : 256;
  const int chunks = (N + ROWS - 1) / ROWS;
  const int64_t tiles = (groups + threads - 1) / threads;
  if (static_cast<int64_t>(B) * chunks > 2147483647LL || tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(B * chunks),
                  static_cast<unsigned>(tiles));
  segment_max_window_direct<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(data), ids, out, N, C, M, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* data, const int* ids, float* out, int B,
                       int N, int C, int M, int device, cudaStream_t stream) {
  constexpr int ELEM = static_cast<int>(sizeof(T));
  constexpr int VEC16 = 16 / ELEM;  // channels in 16 bytes
  const int64_t row_bytes = static_cast<int64_t>(C) * ELEM;
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  if (bulk_path(data, row_bytes)) {
    return launch_bulk<T>(data, ids, out, static_cast<int64_t>(B) * N, N, C,
                          M, device, stream);
  }
  if (row_bytes % 16 == 0 && row_bytes >= 512 && base % 16 == 0) {
    return launch_direct<T, VEC16>(data, ids, out, B, N, C, M, stream);
  }
  if (C % 2 == 0 && base % (2 * ELEM) == 0) {
    return launch_direct<T, 2>(data, ids, out, B, N, C, M, stream);
  }
  return launch_direct<T, 1>(data, ids, out, B, N, C, M, stream);
}

}  // namespace

// 1 if data with rows of C channels takes the bulk kernel, 0 if the direct
// one.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int sonet_segment_max_window_bulk_path(const void* data, int dtype,
                                                  int C) {
  return bulk_path(data, static_cast<int64_t>(C) * (dtype == 0 ? 4 : 2)) ? 1
                                                                          : 0;
}

// For measurements: the bulk kernel's ring.  A value below 1 restores that
// setting's default.
extern "C" void sonet_segment_max_window_config(int stages, int stage_bytes,
                                                int blocks_per_sm) {
  g_config.stages = stages >= 1 ? stages : DEFAULT_CONFIG.stages;
  g_config.stage_bytes =
      stage_bytes >= 1 ? stage_bytes : DEFAULT_CONFIG.stage_bytes;
  g_config.blocks_per_sm =
      blocks_per_sm >= 1 ? blocks_per_sm : DEFAULT_CONFIG.blocks_per_sm;
}

// dtype: 0 = float32, 1 = bfloat16.  On the given device and stream, fills
// out with -3e38, then reduces.  B * N must be below 2^31.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int sonet_segment_max_window(const void* data, int dtype,
                                        const int* ids, float* out, int B,
                                        int N, int C, int M, int device,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(B) * M * C;
  if (n_out == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_empty<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, s>>>(out,
                                                                        n_out);
  err = cudaGetLastError();
  if (err == cudaSuccess && N > 0) {
    err = dtype == 0
              ? launch_any<float>(data, ids, out, B, N, C, M, device, s)
              : launch_any<__nv_bfloat16>(data, ids, out, B, N, C, M, device,
                                          s);
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
