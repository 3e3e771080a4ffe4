// Node recentering's sums, for NVIDIA Hopper (sm_90a): the points each node
// holds and the sum of their coordinates, over rows sorted by node
// (segment_sums in sonet_torch/ops/cuda/segment_sums.py).
//
// Replaces no Pallas kernel.  On the TPU the JAX package recenters the SOM
// nodes with one-hot products on the MXU (sonet_tpu/nn/encoder.py: the
// counts as the one-hot's column sums, the cluster sums as
// einsum("bnm,bnc->bmc", onehot, xs)).  The port carried that over to
// cuBLAS: a float32 FFMA product of depth K = kN whose 64 x 3 output per
// cloud leaves a handful of blocks to walk K in series, fed by a float copy
// and a column sum of the (B, kN, M) one-hot.  On the card's path the rows
// are already sorted by node, so each node's rows are one contiguous run.
// Contract:
//   ids     (B, N) int32 node id per row, sorted non-decreasing in each
//           cloud; ids outside [0, M) count nowhere
//   x       (B, N, D) float32 contiguous, D = 2 or 3
//   counts  (B, M) float32: counts[b, m] = #{n : ids[b, n] == m}, exact
//   sums    (B, M, D) float32: sums[b, m, :] = the sum of x[b, n, :] over
//           those n, in float32
//   An empty node has count 0 and sum 0.
//
// Bound on the H100 (3.35 TB/s): at the flagship (8, 15000, 3), M = 64, the
// function must read x (1.44 MB) and ids (0.48 MB) and write counts and
// sums (8 KB): 1.93 MB, 0.58 us.  It does D adds a row, so memory bounds
// it, and at this size really latency: the launch and a few dependent
// loads.
//
// Design.  One block of 128 threads per (cloud, node): 512 blocks at the
// flagship, one wave.  The block finds its run [first, last) by a search
// over the sorted ids that is 128 wide: a round reads 128 ids spread evenly
// over the rows still open, counts those below the bound's id
// (__syncthreads_count: the ids are sorted, so they are a prefix) and keeps
// the one gap that holds the bound.  Both bounds are searched at once; 15,000
// rows take two rounds of one load a thread each, the second exact.  Then
// the block copies the run into shared memory (coalesced, up to CHUNK rows
// at a time) and D threads add its rows one after another in float32, from
// 0, in row order.  That is the order in which the card's one-hot product
// (cuBLAS's FFMA GEMM, one accumulator an output over K, the other nodes'
// rows adding exact zeros) adds them, and the sort is stable, so a node's
// rows keep their order: the sums are the product's bits, as the scatter
// path computes them from the unsorted rows (for B >= 2; for one cloud
// cuBLAS takes another kernel, which adds in another order).  A run of ~234 rows costs ~234
// dependent adds, under a microsecond.  No atomics: the same input gives the
// same bits every call.  The count is last - first, exact below 2^24.  The
// launch runs on the caller's stream, allocates nothing and can be captured
// in a graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // a block's threads, and a search round's width
constexpr int CHUNK = 1024;   // rows of a run in shared memory at a time

// One round of the search for the first row whose id is at least target,
// known to lie in [lo, hi]: the 128 threads each read an id spread over
// [lo, hi) (every one where the range is 128 rows or fewer, which ends the
// search) and the range shrinks to the gap after the last id below target.
// Every thread of the block calls it, with the same lo and hi.
__device__ __forceinline__ void narrow(const int* __restrict__ ids, int target,
                                       int& lo, int& hi) {
  const int len = hi - lo;
  const int step = len > THREADS ? (len + THREADS - 1) / THREADS : 1;
  const int p = lo + static_cast<int>(threadIdx.x) * step;
  const bool below = p < hi && __ldg(ids + p) < target;
  const int c = __syncthreads_count(below);
  if (c > 0) {
    const int next = lo + c * step;
    lo = lo + (c - 1) * step + 1;
    hi = next < hi ? next : hi;
  } else {
    hi = lo;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    segment_sums_runs(const int* __restrict__ ids, const float* __restrict__ x,
                      float* __restrict__ counts, float* __restrict__ sums,
                      int N, int M) {
  const int64_t node = blockIdx.x;  // b * M + m
  const int64_t b = node / M;
  const int m = static_cast<int>(node - b * M);
  const int* cloud_ids = ids + b * N;

  // [first, last): the rows with id m, found as the first row with an id of
  // at least m and the first with one of at least m + 1
  int lo0 = 0, hi0 = N, lo1 = 0, hi1 = N;
  while (hi0 > lo0 || hi1 > lo1) {
    if (hi0 > lo0) narrow(cloud_ids, m, lo0, hi0);
    if (hi1 > lo1) narrow(cloud_ids, m + 1, lo1, hi1);
  }
  const int first = lo0, last = lo1;

  // the run, CHUNK rows at a time: copied by every thread, added up in
  // row order by thread d for coordinate d
  __shared__ float rows[CHUNK * D];
  const float* run = x + (b * N + first) * D;
  float acc = 0.0f;
  for (int r0 = 0; r0 < last - first; r0 += CHUNK) {
    const int n = min(CHUNK, last - first - r0) * D;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      rows[i] = __ldg(run + static_cast<int64_t>(r0) * D + i);
    }
    __syncthreads();
    if (threadIdx.x < D) {
#pragma unroll 8
      for (int i = threadIdx.x; i < n; i += D) acc += rows[i];
    }
    __syncthreads();
  }
  if (threadIdx.x < D) sums[node * D + threadIdx.x] = acc;
  if (threadIdx.x == 0) counts[node] = static_cast<float>(last - first);
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

// Writes counts (B, M) and sums (B, M, D) float32 of x (B, N, D) float32 over
// ids (B, N) int32 sorted in each cloud, D = 2 or 3, on the given device and
// stream.  Returns the cudaError_t of the launch (0 = success).
extern "C" int sonet_segment_sums(const int* ids, const float* x,
                                  float* counts, float* sums, int B, int N,
                                  int D, int M, int device, void* stream) {
  const int64_t blocks = static_cast<int64_t>(B) * M;
  if (blocks == 0) return 0;
  if ((D != 2 && D != 3) || N < 0 || blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    const dim3 grid(static_cast<unsigned>(blocks));
    if (D == 2) {
      segment_sums_runs<2><<<grid, THREADS, 0, s>>>(ids, x, counts, sums, N,
                                                    M);
    } else {
      segment_sums_runs<3><<<grid, THREADS, 0, s>>>(ids, x, counts, sums, N,
                                                    M);
    }
    return cudaGetLastError();
  });
}
