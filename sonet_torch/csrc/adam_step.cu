// One Adam update of every parameter tensor of a train step, both of the
// optimizer's groups, for NVIDIA Hopper (sm_90a) (adam_step in
// sonet_torch/ops/cuda/adam_step.py).
//
// Replaces no Pallas kernel.  The JAX package's optax Adam is plain XLA that
// the TPU compiler fuses.  The port carried it over to torch.optim.Adam,
// whose capturable foreach chain makes 17 passes a group over the parameter
// lists (the step add; lerp, mul and addcmul on the moments; pow, sub, neg,
// div, reciprocal and sqrt on the step counters; sqrt, div, add and div into
// a temporary the size of exp_avg_sq; addcdiv into the parameter): at least
// 34 launches a step and about 80 bytes a parameter.
// Contract, for each tensor i of the table:
//   p[i], g[i], m[i], v[i]  float32, n[i] elements each, dense and laid out
//                           alike: the parameter, its gradient, exp_avg and
//                           exp_avg_sq
//   step[i]                 float32 counter on the device, or null: then the
//                           host has advanced it and passes its new value
//   inv_lr[i]               1 / its group's learning rate, taken in double
//                           and rounded to float32
// Writes p, m, v and advances step once, by the chain's own float32
// arithmetic (ATen's functors): with t the counter after its increment,
//   m = m + (1 - beta1) * (g - m)                    (lerp, one fma)
//   v = fma(1 - beta2, g * g, v * beta2)             (mul, then addcmul)
//   step_size = 1 / ((beta1^t - 1) * inv_lr)         (powf, sub, div, rcp:
//                                                     the div a product)
//   bc2_sqrt = sqrt(-(beta2^t - 1))                  (powf, sub, neg, sqrt)
//   d = (sqrt(v) / bc2_sqrt + eps) / step_size
//   p = p + m / d                                    (addcdiv, value 1)
// every step rounded as the chain rounds it, so a parameter gets the same
// bits as from torch.optim.Adam(foreach=True, capturable=True).  (ATen's
// foreach division of a list by a Python number is a product with the
// number's reciprocal, taken in double: hence inv_lr.)
//
// Bound on the H100 (3.35 TB/s): each element is read once from p, g, m and
// v and written once to p, m and v, 28 bytes: 0.021 ms for the classifier's
// 2.48 M parameters, 0.170 ms for the autoencoder's 20.3 M.  Fifteen flops
// and a division or two an element: memory bounds it, and at 2.5 M the
// launch and one wave's latency.
//
// Design.  One launch a call (the table travels as the kernel's argument,
// up to 128 tensors; more go in further launches of 128).  The elements of
// the call are cut into chunks of one size, a multiple of 1,024, chosen so
// that one wave of the card's resident blocks covers them; a block takes
// one (tensor, chunk), found by a binary search of the blocks' prefix sums
// in the argument.  256 threads a block each read a float4 of p, g, m and v
// at a time where the tensor's four addresses are 16-byte aligned, and one
// float at a time otherwise and in the chunk's tail.  Every block computes
// its tensor's bias corrections from the counter it reads at its start; the
// last block to finish (a ticket in device memory, reset by that block)
// advances the counters, so no block reads one that was advanced.  No
// atomics on data: the same input gives the same bits every call.  The
// launch runs on the caller's stream, allocates nothing and can be captured
// in a graph; two calls on one device must not run at the same time (they
// would share the ticket).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CAP = 128;          // tensors a launch
constexpr int CHUNK_ALIGN = 1024; // elements: THREADS float4s

struct Table {
  float* p[CAP];
  const float* g[CAP];
  float* m[CAP];
  float* v[CAP];
  float* step[CAP];  // null: the host advanced the counter
  float inv_lr[CAP];
  float host_t[CAP];  // the counter after its increment, where step is null
  int n[CAP];
  int first[CAP + 1];  // prefix sums of the tensors' blocks
  int count;
};

struct Consts {
  float beta1, beta2, w1, w2, eps;  // w1 = 1 - beta1, w2 = 1 - beta2
  int chunk;
};

__device__ unsigned int ticket = 0;

// One element of the chain, rounded as ATen's functors round it.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Consts& c, float bc2_sqrt,
                                       float step_size) {
  m = __fmaf_rn(c.w1, __fsub_rn(g, m), m);
  v = __fmaf_rn(c.w2, __fmul_rn(g, g), __fmul_rn(v, c.beta2));
  float d = __fdiv_rn(__fsqrt_rn(v), bc2_sqrt);
  d = __fdiv_rn(__fadd_rn(d, c.eps), step_size);
  p = __fadd_rn(p, __fdiv_rn(m, d));
}

__global__ void __launch_bounds__(THREADS)
    adam_step_chunks(const __grid_constant__ Table tab,
                     const __grid_constant__ Consts c) {
  const int block = blockIdx.x;
  int lo = 0, hi = tab.count;  // the tensor: first[lo] <= block < first[lo+1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tab.first[mid] <= block) lo = mid; else hi = mid;
  }
  const int i = lo;
  const float t = tab.step[i] ? __fadd_rn(*tab.step[i], 1.0f) : tab.host_t[i];
  const float bc1 = __fmul_rn(__fsub_rn(powf(c.beta1, t), 1.0f),
                              tab.inv_lr[i]);
  const float step_size = __frcp_rn(bc1);
  const float bc2_sqrt = __fsqrt_rn(-__fsub_rn(powf(c.beta2, t), 1.0f));

  const int64_t start = static_cast<int64_t>(block - tab.first[i]) * c.chunk;
  const int n = static_cast<int>(min(static_cast<int64_t>(c.chunk),
                                     tab.n[i] - start));
  float* p = tab.p[i] + start;
  const float* g = tab.g[i] + start;
  float* m = tab.m[i] + start;
  float* v = tab.v[i] + start;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int n4 = aligned ? n >> 2 : 0;
  for (int k = threadIdx.x; k < n4; k += THREADS) {
    float4 p4 = reinterpret_cast<float4*>(p)[k];
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(g) + k);
    float4 m4 = reinterpret_cast<float4*>(m)[k];
    float4 v4 = reinterpret_cast<float4*>(v)[k];
    update(p4.x, g4.x, m4.x, v4.x, c, bc2_sqrt, step_size);
    update(p4.y, g4.y, m4.y, v4.y, c, bc2_sqrt, step_size);
    update(p4.z, g4.z, m4.z, v4.z, c, bc2_sqrt, step_size);
    update(p4.w, g4.w, m4.w, v4.w, c, bc2_sqrt, step_size);
    reinterpret_cast<float4*>(p)[k] = p4;
    reinterpret_cast<float4*>(m)[k] = m4;
    reinterpret_cast<float4*>(v)[k] = v4;
  }
  for (int k = 4 * n4 + threadIdx.x; k < n; k += THREADS) {
    float pk = p[k], mk = m[k], vk = v[k];
    update(pk, __ldg(g + k), mk, vk, c, bc2_sqrt, step_size);
    p[k] = pk;
    m[k] = mk;
    v[k] = vk;
  }

  // the last block to get here has every block's counter read behind it
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int j = threadIdx.x; j < tab.count; j += THREADS) {
    if (tab.step[j]) *tab.step[j] = __fadd_rn(*tab.step[j], 1.0f);
  }
  if (threadIdx.x == 0) ticket = 0;
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

// The blocks of one wave on the current device, SMs x resident blocks,
// asked once a device.
cudaError_t wave_blocks(int* blocks) {
  constexpr int DEVICES = 64;
  static int known[DEVICES] = {0};
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < DEVICES && known[device] > 0) {
    *blocks = known[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, adam_step_chunks, THREADS, 0);
  }
  if (err != cudaSuccess) return err;
  *blocks = sms * (resident > 0 ? resident : 1);
  if (device < DEVICES) known[device] = *blocks;
  return cudaSuccess;
}

}  // namespace

// Updates the count tensors described by ptrs (count x 5: p, g, m, v, step;
// step 0 where the host advanced the counter), numel (count), inv_lr
// (count: 1 / the tensor's learning rate) and host_t (count: the counter
// after its increment, read where step is 0) on the given device and stream, with the chain's float32 constants
// beta1, beta2, w1 = 1 - beta1, w2 = 1 - beta2 and eps.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int sonet_adam_step(int count, const int64_t* ptrs,
                               const int64_t* numel, const float* inv_lr,
                               const float* host_t, float beta1, float beta2,
                               float w1, float w2, float eps, int device,
                               void* stream) {
  if (count <= 0) return 0;
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (numel[i] < 0 || numel[i] >= (int64_t{1} << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    total += numel[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    int wave = 1;
    cudaError_t err = wave_blocks(&wave);
    if (err != cudaSuccess) return err;
    int64_t per_block = (total + wave - 1) / wave;
    per_block = (per_block + CHUNK_ALIGN - 1) / CHUNK_ALIGN * CHUNK_ALIGN;
    Consts c{beta1, beta2, w1, w2, eps,
             static_cast<int>(per_block > CHUNK_ALIGN ? per_block
                                                      : CHUNK_ALIGN)};
    for (int base = 0; base < count; base += CAP) {
      Table tab;
      tab.count = count - base < CAP ? count - base : CAP;
      int64_t blocks = 0;
      for (int j = 0; j < tab.count; ++j) {
        const int64_t* row = ptrs + 5 * static_cast<int64_t>(base + j);
        tab.p[j] = reinterpret_cast<float*>(row[0]);
        tab.g[j] = reinterpret_cast<const float*>(row[1]);
        tab.m[j] = reinterpret_cast<float*>(row[2]);
        tab.v[j] = reinterpret_cast<float*>(row[3]);
        tab.step[j] = reinterpret_cast<float*>(row[4]);
        tab.inv_lr[j] = inv_lr[base + j];
        tab.host_t[j] = host_t[base + j];
        tab.n[j] = static_cast<int>(numel[base + j]);
        tab.first[j] = static_cast<int>(blocks);
        // an empty tensor still gets a block: its counter is read there
        blocks += numel[base + j] > 0 ? (numel[base + j] + c.chunk - 1) /
                                            c.chunk : 1;
      }
      tab.first[tab.count] = static_cast<int>(blocks);
      if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
      adam_step_chunks<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(tab,
                                                                         c);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  });
}
