// K5 — one-sided ring all-reduce (sum), the P2-ordered chain in one kernel.
//
// Replaces the TPU kernel repro/kernels/ring_allreduce.py::ring_all_reduce
// (pallas_call at ring_allreduce.py:108, body _ar_kernel).  The TPU kernel
// runs one program per device: n-1 reduce-scatter hops, each a remote DMA of
// the current partial into the next device's double-buffered landing slot
// with a credit semaphore back to the previous device, then n-1 all-gather
// hops.  Here all n ranks live on one H100 as rows of x (n, row), so a rank
// needs no landing slot: it reads its neighbour's row in place.
//
// Agents.  Each warp is one ring agent: warp g of rank r's blocks walks the
// tiles g, g + G, g + 2G, ... of every chunk (G agents per rank, kTile
// floats a tile, the last tile of a chunk ragged) and, tile by tile, runs
// the ring's S = 2(n-1) - 1 steps on them.  Its word ready[r][g] counts the
// steps it has finished, over all its tiles: step s of its j-th tile
// releases base + s + 1, base = j * S.  With c the chunk and [lo, hi) the
// tile's floats within it:
//
//   reduce-scatter hop k = 0 .. n-2 (step s = k), c = (r-k-1) mod n:
//     k > 0: wait ready[r-1][g] >= base + s        (acquire)
//     own[c] <- own[c] + row(r-1)[c]               (one float add, in place)
//     k = n-2 (the last hop): also row(r+1)[c] <- the same sum, from the
//       same registers — all-gather hop 0, fused
//     release ready[r][g] = base + s + 1
//   all-gather hop k = 1 .. n-2 (step s = n-2+k), c = (r+1-k) mod n:
//     wait ready[r-1][g] >= base + s               (acquire)
//     row(r+1)[c] <- own[c]
//     release ready[r][g] = base + s + 1
//
// so step s waits for the neighbour's step s-1 of the same tile, except
// step 0, which reads only what rank r-1 held at the start.  These are the
// steps of kernels/ring_allreduce.py::agent_program, which
// tests/test_torch_ring.py runs under random interleavings: change both
// together.  Rank r's chunk (r-k-1) after hop k is own + received — the sum
// order of the plan's op-by-op ring (repro/core/rma/collectives.py, ring
// reduce-scatter) — so the result is bit-identical to it.
//
// No credit word: a location read in place is next overwritten only by a
// step that causally follows the read.  Rank r's hop-k read of row r-1,
// chunk (r-k-1), is overwritten next by rank r-2's all-gather hop k, which
// forwards that chunk's final sum; the final sum needs rank r-k-2's last
// hop, which waited (through the chain of release/acquire words) on rank r's
// hop k.  The schedule test checks every read's version rather than this
// argument.
//
// Flags live in global memory and are spun on, so every block of the grid
// must be resident at once: the launch is cooperative.  Data another warp
// wrote is read with ld.global.cg (L2, never a stale L1 line).
//
// Bound on an H100: bytes.  The least traffic is one read and one write of
// x (2X, X = the bytes of x).  Tile by tile, a reduce-scatter hop reads two
// chunks and writes one and an all-gather hop reads one and writes one; the
// fused hop saves one read: (5(n-1) - 1)/n X, 3.5 X at n = 4 (the
// landing-slot design this replaces moved 5.25 X).  With small tiles all n
// ranks walk the same tiles together, so a partial is read back out of L2
// by the next rank a few microseconds after it was written, and the HBM
// traffic falls towards 2X; for that the partials must stay in L2, so every load (each is
// the last read of its value) and every store of a value no later step
// reads carry an L2 evict-first policy.  Each lane keeps kUnroll 16-byte
// loads per operand in flight.  Tiles of 2048 floats, the fused hop, the
// hints and uncapped registers (2 blocks an SM) were the fastest of the
// variants timed at the qwen3-4b gradient shape (PERF.md, K5's findings).
#include "rt_common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kTile = 2048;  // floats a tile

// L2 eviction priorities.  Every load of the ring is the last read of its
// value (the neighbour's partial, or a first touch that this step
// overwrites), and a final value that no later step reads may leave L2
// first: both take an evict-first policy, so the partials a neighbour is
// about to read stay.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float4 ld_cg(const float4* p, uint64_t pol) {
  float4 v;
  asm volatile("ld.global.cg.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void st_cg(float4* p, float4 v, bool final, uint64_t pol) {
  if (!final) return __stcg(p, v);
  asm volatile("st.global.cg.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
               : "memory");
}

// own <- own + in (and also <- the same sum, when also != nullptr), lanes
// striding over [lo, hi), kUnroll 16-byte loads per operand in flight;
// own_final: no later step reads own's new values
__device__ __forceinline__ void step_add(float* own, const float* in, float* also, int lo, int hi,
                                         int lane, bool vec, bool own_final, uint64_t pol) {
  if (!vec) {
    for (int i = lo + lane; i < hi; i += 32) {
      const float v = __ldcg(own + i) + __ldcg(in + i);
      own[i] = v;
      if (also) also[i] = v;
    }
    return;
  }
  float4* o = reinterpret_cast<float4*>(own);
  const float4* s = reinterpret_cast<const float4*>(in);
  float4* a = reinterpret_cast<float4*>(also);
  const int end = hi / 4;
  for (int i = lo / 4 + lane; i < end; i += 32 * kUnroll) {
    float4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + 32 * u < end) {
        va[u] = ld_cg(o + i + 32 * u, pol);
        vb[u] = ld_cg(s + i + 32 * u, pol);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + 32 * u < end) {
        float4 v;
        v.x = va[u].x + vb[u].x;
        v.y = va[u].y + vb[u].y;
        v.z = va[u].z + vb[u].z;
        v.w = va[u].w + vb[u].w;
        st_cg(o + i + 32 * u, v, own_final, pol);
        if (a) __stcg(a + i + 32 * u, v);
      }
    }
  }
}

// dst <- src over [lo, hi); final: no later step reads dst's new values
__device__ __forceinline__ void step_copy(float* dst, const float* src, int lo, int hi, int lane,
                                          bool vec, bool final, uint64_t pol) {
  if (!vec) {
    for (int i = lo + lane; i < hi; i += 32) dst[i] = __ldcg(src + i);
    return;
  }
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  const int end = hi / 4;
  for (int i = lo / 4 + lane; i < end; i += 32 * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + 32 * u < end) v[u] = ld_cg(s + i + 32 * u, pol);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + 32 * u < end) st_cg(d + i + 32 * u, v[u], final, pol);
  }
}

// every lane acquires the word itself (one coalesced poll per warp)
__device__ __forceinline__ void wait_at_least(const unsigned* word, unsigned v) {
  while (rt_ld_acquire(word) < v) __nanosleep(32);
}

// the warp's stores of this step, then the word (release, cumulative over
// the warp's barrier)
__device__ __forceinline__ void release(unsigned* word, unsigned v, int lane) {
  __syncwarp();
  if (lane == 0) rt_st_release(word, v);
}

__global__ void __launch_bounds__(kThreads)
ring_ar_kernel(float* x, int64_t row, int n, int chunk, unsigned* ready, int B, int vec) {
  const int lane = threadIdx.x & 31;
  const uint64_t pol = evict_first_policy();
  const int r = blockIdx.x / B;
  const int G = B * kWarps;
  const int g = (blockIdx.x % B) * kWarps + threadIdx.x / 32;
  const int prv = (r + n - 1) % n;
  float* own = x + (int64_t)r * row;
  const float* prev_row = x + (int64_t)prv * row;
  float* next_row = x + (int64_t)((r + 1) % n) * row;
  unsigned* mine = ready + (int64_t)r * G + g;
  const unsigned* theirs = ready + (int64_t)prv * G + g;
  const unsigned S = 2u * (unsigned)(n - 1) - 1u;  // steps a tile
  const int ntiles = (int)(((int64_t)chunk + kTile - 1) / kTile);
  unsigned base = 0;
  for (int t = g; t < ntiles; t += G, base += S) {
    const int lo = t * kTile;
    const int hi = (int64_t)lo + kTile < chunk ? lo + kTile : chunk;
    // reduce-scatter, steps 0..n-2: rank r's chunk (r-k-1) += rank r-1's,
    // read in place; the last hop also stores the finished chunk into the
    // next row (all-gather hop 0), and rank r's own copy is read no more
    for (int k = 0; k < n - 1; ++k) {
      const int64_t c = ((r - k - 1) % n + n) % n;
      if (k > 0) wait_at_least(theirs, base + k);
      const bool last = k == n - 2;
      step_add(own + c * chunk, prev_row + c * chunk, last ? next_row + c * chunk : nullptr, lo,
               hi, lane, vec, last, pol);
      release(mine, base + k + 1, lane);
    }
    // all-gather hops 1..n-2, steps n-1..S-1: rank r owns chunk (r+1) % n
    // and forwards what it receives
    for (int k = 1; k < n - 1; ++k) {
      const int64_t c = ((r + 1 - k) % n + n) % n;
      const unsigned s = n - 2 + k;
      wait_at_least(theirs, base + s);
      // the last hop's store is read no more
      step_copy(next_row + c * chunk, own + c * chunk, lo, hi, lane, vec, k == n - 2, pol);
      release(mine, base + s + 1, lane);
    }
  }
}

// x: (n, row) float32, row >= n * chunk, chunk < 2^31 - 4; ready: at least
// one word for every warp the card holds at once (ready_words).  The grid is
// every block the card holds at once, split evenly over the n ranks, fewer
// when the chunk is small (an agent for every 128 floats at least).
RT_EXPORT int rt_ring_all_reduce(float* x, int64_t row, int64_t n, int64_t chunk, unsigned* ready,
                                 int64_t ready_words, void* stream) {
  if (n < 2 || chunk < 1 || chunk >= (1ll << 31) - 4 || row < n * chunk) return RT_BAD_ARGUMENT;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_ar_kernel, kThreads, 0);
  if (ce != cudaSuccess) return (int)ce;
  // spin-waits need every block resident at once: at least one a rank
  int64_t B = (int64_t)sms * per_sm / n;
  if (B < 1) return -2;
  const int64_t want = (chunk + 128 * kWarps - 1) / (128 * kWarps);
  if (B > want) B = want;
  const int64_t agents = B * kWarps;
  if (n * agents > ready_words) return RT_BAD_ARGUMENT;
  int vec = (chunk % 4 == 0) && (row % 4 == 0) && ((uintptr_t)x % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  ce = cudaMemsetAsync(ready, 0, sizeof(unsigned) * n * agents, s);
  if (ce != cudaSuccess) return (int)ce;
  int ni = (int)n, ci = (int)chunk, bi = (int)B;
  void* args[] = {&x, &row, &ni, &ci, &ready, &bi, &vec};
  ce = cudaLaunchCooperativeKernel((const void*)ring_ar_kernel, dim3((unsigned)(n * B)),
                                   dim3(kThreads), args, 0, s);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
