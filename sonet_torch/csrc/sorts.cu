// The train step's three sorts as exact selections and counting sorts, for
// NVIDIA Hopper (sm_90a) (node_sort, smallest_k and subset_select in
// sonet_torch/ops/cuda/sorts.py).
//
// Replaces no Pallas kernel.  The JAX package leaves these to XLA on the TPU
// (jax.lax.top_k, jnp.argsort).  The port carried them over as stable
// torch.sort / argsort calls, which sort whole rows to keep a few columns of
// them; rows longer than 4,096 leave PyTorch's in-block sort for its
// device-wide segmented radix sort (fill_index_and_segment and several radix
// passes over every pair).  Each kernel here returns exactly what the stable
// sort gives, bit for bit.
//
// The order.  Ascending by order_key below: -0.0 equals +0.0, every NaN lies
// after +inf and equals every other NaN, and equal keys keep their index
// order.  That is the order of torch.sort(stable=True) on the card and on the
// CPU (its comparator puts NaN last; CUB's radix passes map -0.0 to +0.0).
//
// Contract:
//   smallest_k_sort      d (R, L) float32 -> vals (R, k) float32, idx (R, k)
//                        int64: the first k columns of a stable ascending sort
//                        of each row, 1 <= k <= min(L, 16)
//   node sort            ids (B, L) int32 in [0, M), M <= 1024 -> sorted ids
//                        (B, L) int32, perm (B, L) int64 (sorted position ->
//                        index), inv (B, L) int64 (index -> sorted position),
//                        point0 (B,) int64 = inv[b, 0]: a stable sort of each
//                        cloud's ids; an id outside [0, M) is placed with the
//                        nearest node, and the result is then no sort
//   subset sort          keys (B, L) float32 -> out (B, n) int64: the first n
//                        indices of a stable ascending argsort of each row,
//                        0 <= n <= L
//
// Bounds on the H100 (3.35 TB/s), at the flagship's shapes: smallest_k reads
// (8 * 5000, 64) distances (10.2 MB) and writes 3 columns (1.4 MB), 3.5 us;
// the node sort reads (8, 15000) ids and writes the sorted ids and two
// permutations, 2.4 MB, 0.72 us; the subset sort reads (8, 10000) keys and
// writes (8, 5000) indices, 0.64 MB, 0.19 us.  None does enough arithmetic
// to matter: memory bounds them, and below a few MB the launches and the
// latency of a few dependent rounds do.
//
// Design.
// * smallest_k_sort: G threads a row (G a power of two up to 32, chosen so
//   that about 2^17 threads run), each scanning every G-th column (every G-th
//   float4 where the rows allow it) and keeping the P smallest keys it saw
//   (P = k rounded up to a power of two) as a sorted list of 64-bit keys
//   (order key << 32 | column) in registers: a key under the list's last one
//   is bubbled in with P compare-exchanges.  The column in the low word makes
//   every key distinct, so a plain < gives the lower index on ties.  Then
//   log2(G) butterfly rounds merge the lists of the row's threads: each takes
//   its partner's list by shuffles, keeps the elementwise minimum of its list
//   and the partner's reversed (the P smallest of both, as a bitonic
//   sequence) and sorts that with a bitonic half-cleaner network.  The values
//   written are re-read from d, so they are d's own bits (-0.0 stays -0.0).
// * counting_sort_count, counting_sort_place: a stable counting sort by
//   bucket, a block for each tile of 1,024 items of a cloud, so that a cloud
//   spreads over many SMs.  The first kernel counts each tile's buckets.  The
//   second gives each bucket of its tile its first slot (every item of the
//   lower buckets, then this bucket's items in the lower tiles, read from the
//   counts) and ranks its items: a lane holds 4 of them, a warp a contiguous
//   128, walked 32 at a time; ballots over the bucket's bits group the equal
//   buckets of a step, an item's slot is its (bucket, warp)'s next slot plus
//   its equal items in lower lanes, and per-warp counters in shared memory
//   (counted first, then scanned over the warps) put the lower warps' items
//   first.  So equal buckets keep their index order.  No atomics on the
//   slots: the same input gives the same output.  The node sort is this sort
//   with a node a bucket.
// * subset_sort_rank: the subset sort is the counting sort above into 8
//   items a bucket on average, by the key's value (below 0, [0, 1) spread
//   evenly, then 1 and above and NaN: a map that keeps the order and spreads
//   the uniform keys that the subsample draws), then a thread an item, which
//   counts the smaller keys of its bucket (and the equal ones before it) to
//   find its place.  Any keys are sorted exactly; keys that crowd into few
//   buckets only make those buckets slower to rank.
// Every launch runs on the caller's stream, allocates nothing (the wrapper
// passes the scratch) and can be captured in a graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SELECT_THREADS = 256;
constexpr int64_t SELECT_TARGET_THREADS = int64_t{1} << 17;
constexpr int TILE_THREADS = 256;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_ITEMS = 4;                      // a lane's items
constexpr int TILE = TILE_THREADS * TILE_ITEMS;    // a tile's items
constexpr int MAX_BUCKETS = 1024;
constexpr int THREAD_BUCKETS = MAX_BUCKETS / TILE_THREADS;
constexpr int MAX_GRID_Y = 65535;

// An unsigned key whose order is the ascending order above.
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 0xffffffffu;
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The value of an order key (+0.0 for a zero, a NaN for a NaN).
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// A subsample key's bucket of nb >= 4: below 0, [0, 1) in nb - 2 even
// slices, then 1 and above and NaN; never lower for a later key.
__device__ __forceinline__ int value_bucket(float v, int nb) {
  if (v < 0.0f) return 0;
  if (!(v < 1.0f)) return nb - 1;
  return 1 + min(static_cast<int>(v * static_cast<float>(nb - 2)), nb - 3);
}

// a <= b afterwards
__device__ __forceinline__ void exchange(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  const uint64_t hi = a < b ? b : a;
  a = lo;
  b = hi;
}

template <int P>
__device__ __forceinline__ void insert(uint64_t (&best)[P], float v, int c) {
  uint64_t key = (static_cast<uint64_t>(order_key(v)) << 32) |
                 static_cast<uint32_t>(c);
  if (key < best[P - 1]) {
#pragma unroll
    for (int s = 0; s < P; ++s) exchange(best[s], key);
  }
}

template <int P, bool VEC>
__global__ void __launch_bounds__(SELECT_THREADS)
    smallest_k_sort(const float* __restrict__ d, float* __restrict__ vals,
                    int64_t* __restrict__ idx, int64_t rows, int L, int k,
                    int G) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * SELECT_THREADS +
                    threadIdx.x;
  const int64_t row = t / G;
  const int g = static_cast<int>(t & (G - 1));
  const bool live = row < rows;
  const float* r = d + (live ? row : 0) * L;

  uint64_t best[P];
#pragma unroll
  for (int s = 0; s < P; ++s) best[s] = ~uint64_t{0};
  if (live && VEC) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
#pragma unroll 2
    for (int c = g; c < L / 4; c += G) {
      const float4 v = __ldg(r4 + c);
      insert(best, v.x, 4 * c);
      insert(best, v.y, 4 * c + 1);
      insert(best, v.z, 4 * c + 2);
      insert(best, v.w, 4 * c + 3);
    }
  } else if (live) {
#pragma unroll 4
    for (int c = g; c < L; c += G) insert(best, __ldg(r + c), c);
  }
  // a row's G threads are adjacent lanes of one warp; every lane of the
  // warp takes part in each round, live or not
  for (int m = 1; m < G; m <<= 1) {
    uint64_t other[P];
#pragma unroll
    for (int s = 0; s < P; ++s) other[s] = __shfl_xor_sync(FULL, best[s], m);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      best[s] = best[s] < other[P - 1 - s] ? best[s] : other[P - 1 - s];
    }
#pragma unroll
    for (int h = P / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int s = 0; s < P; ++s) {
        if ((s & h) == 0) exchange(best[s], best[s + h]);
      }
    }
  }
  if (live && g == 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (s < k) {
        const int c = static_cast<int>(static_cast<uint32_t>(best[s]));
        idx[row * k + s] = c;
        vals[row * k + s] = r[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the stable counting sort by bucket, a block a tile
// ---------------------------------------------------------------------------

// Node ids: an id's bucket is the id (clamped into [0, M)).
struct NodeBuckets {
  const int* ids;
  int M;
  __device__ int operator()(int64_t b, int i, int L) const {
    return min(max(__ldg(ids + b * L + i), 0), M - 1);
  }
};

// Subsample keys: a key's bucket of its value.
struct KeyBuckets {
  const float* keys;
  int nb;
  __device__ int operator()(int64_t b, int i, int L) const {
    return value_bucket(__ldg(keys + b * L + i), nb);
  }
};

// The node sort's outputs, written for the item i that goes to slot pos.
struct NodeOut {
  const int* ids;
  int* sorted;
  int64_t* perm;
  int64_t* inv;
  int64_t* point0;
  __device__ void item(int64_t b, int pos, int i, int L) const {
    sorted[b * L + pos] = __ldg(ids + b * L + i);
    perm[b * L + pos] = i;
    inv[b * L + i] = pos;
    if (i == 0) point0[b] = pos;
  }
  __device__ void bucket_start(int64_t, int, int, int) const {}
};

// The subset sort's items in bucket order, each bucket's first slot, and
// the bucket count (nb + 1 starts a cloud).
struct BucketedOut {
  const float* keys;
  uint32_t* skey;
  int* sidx;
  int* starts;
  __device__ void item(int64_t b, int pos, int i, int L) const {
    skey[b * L + pos] = order_key(__ldg(keys + b * L + i));
    sidx[b * L + pos] = i;
  }
  __device__ void bucket_start(int64_t b, int m, int start, int nb) const {
    starts[b * (nb + 1) + m] = start;
  }
};

// Exclusive prefix sum of one value a thread over a block of TILE_THREADS;
// scratch holds TILE_WARPS ints.  Every thread calls it.
__device__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + x - v;
}

// The lanes of a warp whose items have bucket m (-1 for a lane without an
// item: those match only each other), from one ballot a bit of the bucket.
__device__ __forceinline__ unsigned same_bucket(int m, int bits) {
  const bool valid = m >= 0;
  unsigned peers = __ballot_sync(FULL, valid);
  if (!valid) peers = ~peers;
  for (int k = 0; k < bits; ++k) {
    const bool bit = (m >> k) & 1;
    const unsigned ones = __ballot_sync(FULL, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// A tile's items: the lane's u-th is item w * 32 * TILE_ITEMS + 32 u + lane
// of the tile, so (warp, u, lane) is index order.
__device__ __forceinline__ int tile_item(int t, int u) {
  return t * TILE + (threadIdx.x >> 5) * 32 * TILE_ITEMS + 32 * u +
         static_cast<int>(threadIdx.x & 31);
}

// counts[(b * tiles + t) * buckets + m]: tile t of cloud b's items in bucket
// m.  Grid (B, tiles).
template <class Buckets>
__global__ void __launch_bounds__(TILE_THREADS)
    counting_sort_count(Buckets bucket_of, int L, int buckets,
                        int* __restrict__ counts) {
  __shared__ int hist[MAX_BUCKETS];
  const int64_t b = blockIdx.x;
  const int t = blockIdx.y, tiles = gridDim.y;
  for (int m = threadIdx.x; m < buckets; m += TILE_THREADS) hist[m] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < TILE_ITEMS; ++u) {
    const int i = tile_item(t, u);
    if (i < L) atomicAdd(&hist[bucket_of(b, i, L)], 1);
  }
  __syncthreads();
  int* out = counts + (b * tiles + t) * buckets;
  for (int m = threadIdx.x; m < buckets; m += TILE_THREADS) out[m] = hist[m];
}

// Writes each item of tile t of cloud b to its slot of the stable sort by
// bucket (out.item), and, from tile 0, each bucket's first slot
// (out.bucket_start).  bits: enough to write any bucket.  Grid (B, tiles).
template <class Buckets, class Out>
__global__ void __launch_bounds__(TILE_THREADS)
    counting_sort_place(Buckets bucket_of, Out out, int L, int buckets,
                        int bits, const int* __restrict__ counts) {
  __shared__ int slot[TILE_WARPS * MAX_BUCKETS];  // [warp][bucket]
  __shared__ int scratch[TILE_WARPS];
  const int64_t b = blockIdx.x;
  const int t = blockIdx.y, tiles = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int* mine = slot + warp * buckets;

  int bucket[TILE_ITEMS];
#pragma unroll
  for (int u = 0; u < TILE_ITEMS; ++u) {
    const int i = tile_item(t, u);
    bucket[u] = i < L ? bucket_of(b, i, L) : -1;
  }
  for (int m = threadIdx.x; m < TILE_WARPS * buckets; m += TILE_THREADS) {
    slot[m] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < TILE_ITEMS; ++u) {
    const unsigned peers = same_bucket(bucket[u], bits);
    if (bucket[u] >= 0 && (peers & below) == 0) {
      mine[bucket[u]] += __popc(peers);
    }
    __syncwarp();
  }

  // this thread's buckets, contiguous: the cloud's count of each, and the
  // lower tiles' count of each (the tiles' loads unrolled, so that several
  // are in flight at once)
  const int per = (buckets + TILE_THREADS - 1) / TILE_THREADS;
  const int m0 = threadIdx.x * per;
  int total[THREAD_BUCKETS] = {}, lower[THREAD_BUCKETS] = {};
  const int* c = counts + b * tiles * buckets + m0;
#pragma unroll 4
  for (int s = 0; s < tiles; ++s) {
#pragma unroll
    for (int j = 0; j < THREAD_BUCKETS; ++j) {
      if (j < per && m0 + j < buckets) {
        const int n = __ldg(c + s * buckets + j);
        total[j] += n;
        lower[j] += s < t ? n : 0;
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < THREAD_BUCKETS; ++j) sum += total[j];
  // (the scan's barrier also ends every warp's counting)
  int start = block_exclusive_scan(sum, scratch);
#pragma unroll
  for (int j = 0; j < THREAD_BUCKETS; ++j) {
    const int m = m0 + j;
    if (j < per && m < buckets) {
      if (t == 0) out.bucket_start(b, m, start, buckets);
      int run = start + lower[j];
      for (int w = 0; w < TILE_WARPS; ++w) {
        const int n = slot[w * buckets + m];
        slot[w * buckets + m] = run;
        run += n;
      }
      start += total[j];
    }
  }
  if (t == 0 && threadIdx.x == 0) out.bucket_start(b, buckets, L, buckets);
  __syncthreads();

#pragma unroll
  for (int u = 0; u < TILE_ITEMS; ++u) {
    const unsigned peers = same_bucket(bucket[u], bits);
    if (bucket[u] >= 0) {
      out.item(b, mine[bucket[u]] + __popc(peers & below), tile_item(t, u),
               L);
    }
    __syncwarp();
    if (bucket[u] >= 0 && (peers & below) == 0) {
      mine[bucket[u]] += __popc(peers);
    }
    __syncwarp();
  }
}

// out[b, pos] = index of the item at sorted position pos < n: each item of
// the bucketed keys counts the smaller keys of its bucket, and the equal
// ones before it (a bucket keeps index order).  Grid (B, ceil(L / 256)).
__global__ void __launch_bounds__(TILE_THREADS)
    subset_sort_rank(const uint32_t* __restrict__ skey,
                     const int* __restrict__ sidx,
                     const int* __restrict__ starts, int64_t* __restrict__ out,
                     int L, int n, int nb) {
  const int64_t b = blockIdx.x;
  const int p = blockIdx.y * TILE_THREADS + threadIdx.x;
  if (p >= L) return;
  const uint32_t* keys = skey + b * L;
  const uint32_t key = keys[p];
  const int m = value_bucket(key_value(key), nb);
  const int first = starts[b * (nb + 1) + m];
  const int last = starts[b * (nb + 1) + m + 1];
  int pos = first;
#pragma unroll 4
  for (int q = first; q < last; ++q) {
    const uint32_t other = __ldg(keys + q);
    pos += other < key || (other == key && q < p);
  }
  if (pos < n) out[b * n + pos] = sidx[b * L + p];
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

template <int P>
cudaError_t launch_smallest_k(const float* d, float* vals, int64_t* idx,
                              int64_t rows, int L, int k, cudaStream_t s) {
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const int units = vec ? L / 4 : L;
  int G = 1;
  while (G < 32 && G < units && rows * G < SELECT_TARGET_THREADS) G <<= 1;
  const int64_t blocks = (rows * G + SELECT_THREADS - 1) / SELECT_THREADS;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec) {
    smallest_k_sort<P, true><<<grid, SELECT_THREADS, 0, s>>>(d, vals, idx,
                                                             rows, L, k, G);
  } else {
    smallest_k_sort<P, false><<<grid, SELECT_THREADS, 0, s>>>(d, vals, idx,
                                                              rows, L, k, G);
  }
  return cudaGetLastError();
}

// ceil(log2(n)) for n >= 1
int bits_for(int n) {
  int bits = 0;
  while ((1 << bits) < n) ++bits;
  return bits;
}

template <class Buckets, class Out>
cudaError_t launch_counting_sort(Buckets bucket_of, Out out, int B, int L,
                                 int buckets, int* counts, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((L + TILE - 1) / TILE));
  counting_sort_count<Buckets><<<grid, TILE_THREADS, 0, s>>>(bucket_of, L,
                                                             buckets, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  counting_sort_place<Buckets, Out><<<grid, TILE_THREADS, 0, s>>>(
      bucket_of, out, L, buckets, bits_for(buckets), counts);
  return cudaGetLastError();
}

}  // namespace

// Writes vals (rows, k) float32 and idx (rows, k) int64: the k smallest of
// each row of d (rows, L) float32 with their columns, in the stable ascending
// order, 1 <= k <= min(L, 16).  Returns the cudaError_t of the launch.
extern "C" int sonet_smallest_k(const float* d, float* vals, int64_t* idx,
                                long long rows, int L, int k, int device,
                                void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || L < 1 || k < 1 || k > L || k > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (k <= 1) return launch_smallest_k<1>(d, vals, idx, rows, L, k, s);
    if (k <= 2) return launch_smallest_k<2>(d, vals, idx, rows, L, k, s);
    if (k <= 4) return launch_smallest_k<4>(d, vals, idx, rows, L, k, s);
    if (k <= 8) return launch_smallest_k<8>(d, vals, idx, rows, L, k, s);
    return launch_smallest_k<16>(d, vals, idx, rows, L, k, s);
  });
}

// The number of tiles of a cloud of L items, and so of ints a cloud and a
// bucket that the sorts' counts scratch takes.
extern "C" int sonet_sort_tiles(int L) { return (L + TILE - 1) / TILE; }

// Writes the stable sort of each cloud's ids (B, L) int32 in [0, M): sorted
// (B, L) int32, perm and inv (B, L) int64 and point0 (B,) int64, with counts
// (B, tiles, M) int32 of scratch; 1 <= M <= 1024, L >= 1.  Returns the
// cudaError_t of the launches.
extern "C" int sonet_node_sort(const int* ids, int* sorted, int64_t* perm,
                               int64_t* inv, int64_t* point0, int* counts,
                               int B, int L, int M, int device, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || L < 1 || M < 1 || M > MAX_BUCKETS ||
      sonet_sort_tiles(L) > MAX_GRID_Y) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return launch_counting_sort(NodeBuckets{ids, M},
                                NodeOut{ids, sorted, perm, inv, point0}, B, L,
                                M, counts, s);
  });
}

// The buckets of the subset sort for rows of L keys: about 8 keys a bucket,
// a power of two from 4 to 1024.
extern "C" int sonet_subset_buckets(int L) {
  int nb = 4;
  while (nb < MAX_BUCKETS && nb * 8 < L) nb <<= 1;
  return nb;
}

// Writes out (B, n) int64: the first n indices of a stable ascending argsort
// of each row of keys (B, L) float32, 0 <= n <= L, with scratch of counts
// (B, tiles, nb) int32, skey and sidx (B, L) 32-bit and starts (B, nb + 1)
// int32, nb = sonet_subset_buckets(L).  Returns the cudaError_t of the
// launches.
extern "C" int sonet_subset_select(const float* keys, int64_t* out,
                                   int* counts, uint32_t* skey, int* sidx,
                                   int* starts, int B, int L, int n,
                                   int device, void* stream) {
  if (B == 0 || n == 0) return 0;
  if (B < 0 || L < 1 || n < 0 || n > L ||
      sonet_sort_tiles(L) > MAX_GRID_Y ||
      (L + TILE_THREADS - 1) / TILE_THREADS > MAX_GRID_Y) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = sonet_subset_buckets(L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    cudaError_t err = launch_counting_sort(
        KeyBuckets{keys, nb}, BucketedOut{keys, skey, sidx, starts}, B, L, nb,
        counts, s);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(B),
                    static_cast<unsigned>((L + TILE_THREADS - 1) /
                                          TILE_THREADS));
    subset_sort_rank<<<grid, TILE_THREADS, 0, s>>>(skey, sidx, starts, out, L,
                                                   n, nb);
    return cudaGetLastError();
  });
}
