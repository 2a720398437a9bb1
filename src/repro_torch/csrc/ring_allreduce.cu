// K5 — one-sided ring all-reduce (sum), the P2-ordered chain in one kernel.
//
// Replaces the TPU kernel repro/kernels/ring_allreduce.py::ring_all_reduce
// (pallas_call at ring_allreduce.py:108, body _ar_kernel).  The TPU kernel
// runs one program per device: n-1 reduce-scatter hops, each a remote DMA of
// the current partial into the next device's double-buffered landing slot
// with a credit semaphore back to the previous device, then n-1 all-gather
// hops.  Here all n ranks live on one H100 as rows of x (n, row): one
// persistent kernel of n x B blocks, block (r, b) acting for rank r on column
// slice b of every chunk.  Hop k of the reduce-scatter is
//
//     wait credit[next] >= k-1  (k >= 2: the slot's previous hop was drained)
//     landing[next][k % 2] <- own[r-k]       ; release ready[next] = k+1
//     wait ready[r] >= k+1                  ; acquire
//     own[r-k-1] <- own[r-k-1] + landing[r][k % 2]  ; release credit[r] = k+1
//
// so rank r's chunk (r-k-1) after hop k is own + received — exactly the sum
// order of the plan's op-by-op ring (repro/core/rma/collectives.py, ring
// reduce-scatter), and the result is bit-identical to it.  After the
// reduce-scatter rank r owns chunk (r+1) % n; the all-gather forwards owned
// chunks straight into the next rank's row (every location is written once,
// so no landing slot is needed), released and acquired on the same ready word.
//
// Flags live in global memory and are spun on, so every block of the grid
// must be resident at once: the launch is cooperative and n x B <= the SM
// count.  Data that another block wrote is read with ld.global.cg (L2, never
// a stale L1 line).
//
// Bound on an H100: bytes.  The least traffic is one read and one write of
// x; the ring moves each chunk through a landing slot (write, read) on
// every reduce-scatter hop and once more per all-gather hop, about
// (5 (n-1) + 2 (n-1)) / 2 times that least traffic at n ranks.
#include "rt_common.cuh"

__device__ __forceinline__ void slice_copy(float* dst, const float* src, int64_t lo, int64_t hi,
                                           bool vec) {
  if (vec) {
    float4* d = reinterpret_cast<float4*>(dst);
    const float4* s = reinterpret_cast<const float4*>(src);
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += blockDim.x) d[i] = __ldcg(s + i);
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = __ldcg(src + i);
  }
}

// own <- own + incoming, element by element (one float add each)
__device__ __forceinline__ void slice_add(float* own, const float* in, int64_t lo, int64_t hi,
                                          bool vec) {
  if (vec) {
    float4* o = reinterpret_cast<float4*>(own);
    const float4* s = reinterpret_cast<const float4*>(in);
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += blockDim.x) {
      float4 a = __ldcg(o + i);
      const float4 b = __ldcg(s + i);
      a.x = a.x + b.x;
      a.y = a.y + b.y;
      a.z = a.z + b.z;
      a.w = a.w + b.w;
      o[i] = a;
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) own[i] = __ldcg(own + i) + __ldcg(in + i);
  }
}

__device__ __forceinline__ void wait_at_least(const unsigned* word, unsigned v) {
  if (threadIdx.x == 0) {
    while (rt_ld_acquire(word) < v) __nanosleep(64);
  }
  __syncthreads();
}

__device__ __forceinline__ void signal(unsigned* word, unsigned v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) rt_st_release(word, v);
}

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
ring_ar_kernel(float* x, int64_t row, int n, int64_t chunk, float* landing, unsigned* flags,
               int B, int vec) {
  const int r = blockIdx.x / B;
  const int b = blockIdx.x % B;
  int64_t per = (chunk + B - 1) / B;
  if (vec) per = (per + 3) / 4 * 4;
  const int64_t lo = (int64_t)b * per;
  const int64_t hi = lo + per < chunk ? lo + per : chunk;
  // the slice depends on b alone, so every rank's block b leaves together
  if (lo >= hi) return;
  const int nxt = (r + 1) % n;
  unsigned* ready = flags;
  unsigned* credit = flags + n * B;
  float* own = x + (int64_t)r * row;
  float* next_row = x + (int64_t)nxt * row;

  // reduce-scatter: n-1 hops through the next rank's double-buffered slots
  for (int k = 0; k < n - 1; ++k) {
    const int send_c = ((r - k) % n + n) % n;
    const int recv_c = ((r - k - 1) % n + n) % n;
    const int slot = k & 1;
    if (k >= 2) wait_at_least(credit + nxt * B + b, (unsigned)(k - 1));
    slice_copy(landing + ((int64_t)nxt * 2 + slot) * chunk, own + (int64_t)send_c * chunk, lo, hi,
               vec);
    signal(ready + nxt * B + b, (unsigned)(k + 1));
    wait_at_least(ready + r * B + b, (unsigned)(k + 1));
    slice_add(own + (int64_t)recv_c * chunk, landing + ((int64_t)r * 2 + slot) * chunk, lo, hi,
              vec);
    signal(credit + r * B + b, (unsigned)(k + 1));
  }
  // all-gather: rank r owns chunk (r+1) % n and forwards what it receives
  for (int k = 0; k < n - 1; ++k) {
    const int c = ((r + 1 - k) % n + n) % n;
    slice_copy(next_row + (int64_t)c * chunk, own + (int64_t)c * chunk, lo, hi, vec);
    signal(ready + nxt * B + b, (unsigned)(n + k));
    wait_at_least(ready + r * B + b, (unsigned)(n + k));
  }
}

RT_EXPORT int rt_ring_all_reduce(float* x, int64_t row, int64_t n, int64_t chunk, float* landing,
                                 unsigned* flags, int B, void* stream) {
  if (n < 2 || chunk < 1 || B < 1 || row < n * chunk) return RT_BAD_ARGUMENT;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_ar_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  // spin-waits need every block resident at once
  if ((int64_t)n * B > (int64_t)sms * per_sm) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(flags, 0, sizeof(unsigned) * 2 * n * B, s);
  if (e != cudaSuccess) return (int)e;
  int vec = (chunk % 4 == 0) && (row % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
            ((uintptr_t)landing % 16 == 0);
  int ni = (int)n;
  void* args[] = {&x, &row, &ni, &chunk, &landing, &flags, &B, &vec};
  e = cudaLaunchCooperativeKernel((const void*)ring_ar_kernel, dim3((unsigned)(n * B)),
                                  dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
