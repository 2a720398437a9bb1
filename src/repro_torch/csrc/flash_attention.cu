// K7 — flash attention, forward: blockwise online-softmax attention on
// (B, H, S, D) with a float32 running max, denominator and accumulator.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:84, body _flash_kernel).  The TPU grid
// (B*H, q-blocks, kv-blocks) runs its kv axis in order and carries m, l and
// the accumulator in VMEM scratch across the kv steps.  Here one CTA owns one
// (b*h, q tile) and walks the kv tiles in a loop of its own, so nothing is
// carried between blocks.  Causal kv tiles wholly above the diagonal are
// skipped: the TPU kernel adds exp(NEG_INF - m) = 0 for them, so the result
// is the same.
//
// What it computes, as _flash_kernel: scores in float32 scaled by `scale`,
// masked scores (qpos < kpos) set to NEG_INF = -2^30 (finite, no NaN from
// (-inf) - (-inf)), online max and denominator, out = acc / max(l, 1e-30)
// cast to the input type.  Keys past sk (a ragged last tile) weigh exactly 0.
// GQA: query head h reads kv head h / (H / KV), which is the expanded call's
// result without the copy.
//
// Bound on an H100: operations.  At the prefill shape (1, 32, 1024, 128)
// bfloat16, causal, the causal pairs are 8.6 GFLOP against 21 MB of input and
// output: 0.0087 ms at the bf16 tensor-core peak, the bytes 0.0063 ms.  Only
// the tensor cores come near it, so the bfloat16 path is built for them:
//
// * bfloat16 (flash_fwd_wgmma_kernel): a CTA of two consumer warpgroups owns
//   128 query rows (64 each).  S = Q K^T is a wgmma with both operands in
//   shared memory and float32 accumulators in registers; the softmax runs on
//   those fragments (row max and sum by quad shuffles, the causal mask only on
//   tiles that cross the diagonal or the end of the keys), and P, rounded to
//   bf16 in registers as the JAX serving path rounds its weights, is the
//   register A operand of O += P V, with V read in its row-major (kv, d)
//   layout through wgmma's transpose bit.  No score touches shared memory.
//   Q arrives by one TMA load; K and V tiles of 128 keys through a two-stage
//   ring of TMA loads completing on mbarriers, so the loads of tile t + 1
//   run under the products of tile t.  Every tile is cut in boxes of 64
//   columns (128 bytes, the 128-byte swizzle the wgmma descriptors read);
//   a head dim short of whole boxes (16, 32, 96) is zero-filled by TMA up
//   to them and clipped on the store.  The tensor maps are 4-D (d, s, heads, batch) with the caller's
//   strides, so q, k, v and o may be head-transposed views of (B, S, H, D)
//   tensors; bases and strides must be multiples of 16 bytes (the wrapper
//   checks and raises).  Rows past S read as zeros and the output's TMA
//   store clips them, so no end pad is needed.  The maps are encoded per
//   call on the host (their base address is in them) through
//   cuTensorMapEncodeTiled, a libcuda function looked up through the CUDA
//   runtime's entry-point query: the library links no libcuda.
//   Query tiles launch heaviest first (the causal work grows with the tile
//   index), so the longest CTAs do not run last on a partly idle card.
//   Tiles of 128 keys fit the registers at D = 128: ptxas -v reports 178
//   registers a thread and no spills (151 at D <= 64), with 161 KB of
//   dynamic shared memory, so one CTA runs per SM.  That is what holds it
//   back at the prefill shape: each CTA's prologue (barrier set-up, the Q
//   and first K/V loads) and epilogue (normalise, store) leave the tensor
//   cores idle, and at S = 1024 a CTA owns only 1 to 8 tiles.  Longer rows
//   amortise it (benchmarks_torch/flash_bench.py); a persistent grid that
//   loads the next tile's Q under the current one's epilogue is the next
//   step.
// * float32 (flash_fwd_simt_kernel): the first version of K7, kept because
//   float32 must meet the reference tolerance of 2e-5, which TF32 tensor
//   cores do not: 64 x 64 tiles computed on the CUDA cores in float32,
//   staged through shared memory with rows padded by one word.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <math.h>

#include "rt_common.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2^30, the reference's mask value
constexpr int RT_TMA_REFUSED = -2;         // cuTensorMapEncodeTiled refused a map

// ---- float32: the SIMT kernel ------------------------------------------------
namespace simt {

constexpr int BQ = 64;     // query rows per CTA
constexpr int BKV = 64;    // keys per kv tile
constexpr int NT = 256;    // threads: 16 x 16, each owns 4 rows

// Stage rows [r0, r0 + ROWS) of a (n, D) matrix into shared memory (row
// stride D + 1), times `mul`; rows past n are zero.
template <int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t r0, int64_t n,
                                      float mul) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int64_t g = r0 + r;
    dst[r * (D + 1) + c] = g < n ? src[g * D + c] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H, int KV,
                      int64_t sq, int64_t sk, float scale, int causal) {
  constexpr int LD = D + 1;       // padded row stride of the q and kv tiles
  constexpr int LP = BKV + 1;     // padded row stride of the score tile
  constexpr int CPT = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // BQ x LD, already scaled
  float* kvs = qs + BQ * LD;      // BKV x LD: the K tile, then the V tile
  float* ps = kvs + BKV * LD;     // BQ x LP: scores, then probabilities
  float* m_s = ps + BQ * LP;      // running max per row
  float* l_s = m_s + BQ;          // running denominator per row
  float* a_s = l_s + BQ;          // this tile's rescale factor per row

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const float* qp = q + (int64_t)bh * sq * D;
  const float* kp = k + (int64_t)(b * KV + kvh) * sk * D;
  const float* vp = v + (int64_t)(b * KV + kvh) * sk * D;
  float* op = o + (int64_t)bh * sq * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 + i, columns tx + 16*j

  stage<D, BQ>(qs, qp, q0, sq, scale);
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int64_t n_kv = (sk + BKV - 1) / BKV;
  if (causal) {
    const int64_t last_q = (q0 + BQ < sq ? q0 + BQ : sq) - 1;
    if (last_q / BKV + 1 < n_kv) n_kv = last_q / BKV + 1;
  }
  for (int64_t t = 0; t < n_kv; ++t) {
    const int64_t k0 = t * BKV;
    stage<D, BKV>(kvs, kp, k0, sk, 1.f);
    __syncthreads();
    // S = (q * scale) K^T over the 4 x 4 scores this thread owns
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        float val = s[i][j];
        if (causal && q0 + r < k0 + c) val = NEG_INF;
        if (k0 + c >= sk) val = -INFINITY;   // no such key: weight exactly 0
        ps[r * LP + c] = val;
      }
    }
    __syncthreads();
    // the K tile is spent: stage V while the rows update their statistics
    stage<D, BKV>(kvs, vp, k0, sk, 1.f);
    {
      const int r = tid >> 2, part = tid & 3;   // 4 lanes per row, 16 columns each
      float* prow = ps + r * LP + part * 16;
      const float m_prev = m_s[r];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty * 4 + i) * LP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vb = kvs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
    __syncthreads();   // the next tile overwrites kvs and ps
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int64_t g = q0 + r;
    if (g >= sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) op[g * D + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t H,
           int64_t KV, int64_t sq, int64_t sk, float scale, int causal, cudaStream_t s) {
  constexpr size_t bytes = sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) +
                                            (size_t)BQ * (BKV + 1) + 3 * BQ);
  static bool opted_in = false;   // above 48 KB only after opting in, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_simt_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  dim3 grid((unsigned)rt_cdiv(sq, BQ), (unsigned)(B * H));
  flash_fwd_simt_kernel<D><<<grid, NT, bytes, s>>>((const float*)q, (const float*)k,
                                                   (const float*)v, (float*)o, (int)H, (int)KV,
                                                   sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---- bfloat16: wgmma on TMA-fed tiles -----------------------------------------
namespace hopper {

constexpr int BQ = 128;        // query rows per CTA: two consumer warpgroups of 64
constexpr int BKV = 128;       // keys per kv tile
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int NT = 256;        // two warpgroups
constexpr int BOX = 64;        // bf16 columns per TMA box: 128 bytes, the swizzle span
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory into a 4-D tensor map (clipped at its bounds)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: pin them at this point, so
// the compiler neither reads a result nor reuses an operand register before
// the wait that precedes the call.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzled layout
// TMA writes: start address, leading and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D (64 x 128, f32) += A (64 x 16, smem) * B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem), B MN-major
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One CTA: 128 query rows of one (batch, head) over the kv tiles the causal
// mask leaves.  Thread 0 issues every TMA load; each warp releases a ring
// stage after its warpgroup's products on it have completed.
template <int NCB>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int H, int group, int sq,
                       int sk, float scale, int causal) {
  constexpr int NS = BKV / 2;                  // score registers per thread
  constexpr uint32_t Q_BOX = BQ * 128;         // bytes of one 64-column box of Q
  constexpr uint32_t KV_BOX = BKV * 128;       // ... of a K or a V tile
  constexpr uint32_t KV_TILE = NCB * KV_BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t ks = qs + NCB * Q_BOX;        // STAGES K tiles
  const uint32_t vs = ks + STAGES * KV_TILE;   // STAGES V tiles
  const uint32_t qbar = vs + STAGES * KV_TILE; // then full[STAGES], empty[STAGES]
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first
  int n_kv = (sk + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, sq) - 1) / BKV + 1);

  const CUtensorMap *mk = &tk, *mv = &tv;
  auto load_kv = [=](int t, int s) {   // tile t of K and V into ring stage s
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, 2 * KV_TILE);
#pragma unroll
    for (int c = 0; c < NCB; ++c) {
      tma_load(ks + s * KV_TILE + c * KV_BOX, mk, bar, c * BOX, t * BKV, kvh, b);
      tma_load(vs + s * KV_TILE + c * KV_BOX, mv, bar, c * BOX, t * BKV, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per warp of both warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, NCB * Q_BOX);
#pragma unroll
    for (int c = 0; c < NCB; ++c) tma_load(qs + c * Q_BOX, &tq, qbar, c * BOX, q0, h, b);
    for (int t = 0; t < STAGES && t < n_kv; ++t) load_kv(t, t);
  }

  // accumulator fragment of a 64 x N wgmma: register 4j + e holds row
  // 16 * warp + lane / 4 + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;   // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane % 4);
  const uint32_t qw = qs + wg * 64 * 128;                // this warpgroup's 64 Q rows
  float o[NCB][32];
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % STAGES;
    const uint32_t phase = (t / STAGES) & 1;
    const uint32_t kt = ks + s * KV_TILE, vt = vs + s * KV_TILE;
    mbar_wait(full0 + 8 * s, phase);

    // S = Q K^T: K-major operands, 16 columns of d per step
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NCB * 4; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 bf16 along the 128-byte row
      wgmma_ss(sc, desc_sw128(qw + (kk / 4) * Q_BOX + off, 1, 64),
               desc_sw128(kt + (kk / 4) * KV_BOX + off, 1, 64), 1);
    }
    wg_commit();
    wg_wait_all();
    pin(sc);

    // scale, mask (only where the tile crosses the diagonal or the keys' end)
    const int k0 = t * BKV;
    const bool edge = k0 + BKV > sk || (causal && k0 + BKV - 1 > q0 + wg * 64);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int e = i % 4, half = e / 2;
      float x = sc[i] * scale;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + cq + (e & 1);
        if (causal && key > r0 + 8 * half) x = NEG_INF;
        if (key >= sk) x = -INFINITY;   // no such key: weight exactly 0
      }
      sc[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], quad_max(mx[half]));
      alpha[half] = exp2f((m[half] - m_new) * LOG2E);
      m[half] = m_new;
      mb[half] = m_new * LOG2E;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int half = (i % 4) / 2;
      sc[i] = exp2f(fmaf(sc[i], LOG2E, -mb[half]));
      ps[half] += sc[i];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * alpha[half] + ps[half];
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i % 4) / 2];

    // P in bf16 as the A operand: the accumulator fragment of 16 keys is the
    // A fragment of a k16 step
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

    // O += P V: V is (kv, d) row-major, read MN-major through the transpose
    // bit; one n64 product per 64-column box
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NCB; ++c)
        wgmma_rs_n64_tb(o[c], pa[kk], desc_sw128(vt + c * KV_BOX + kk * 16 * 128, 64, 64));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NCB; ++c) pin(o[c]);
    pin(pa);

    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (tid == 0 && t + STAGES < n_kv) {
      mbar_wait(empty0 + 8 * s, phase);   // both warpgroups are done with tile t
      load_kv(t + STAGES, s);
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-30) in bf16, through this warpgroup's Q rows (free
  // now) in the swizzled layout, and one TMA store per box (rows past sq and
  // columns past D clipped)
  float den[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) den[half] = fmaxf(quad_sum(l[half]), 1e-30f);
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + lane / 4 + 8 * half;
        const uint32_t addr = qw + c * Q_BOX + r * 128 + ((j ^ (r & 7)) * 16) + cq * 2;
        const uint32_t val = pack_bf16(o[c][4 * j + 2 * half] / den[half],
                                       o[c][4 * j + 2 * half + 1] / den[half]);
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(val) : "memory");
      }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (tid % 128 == 0) {
#pragma unroll
    for (int c = 0; c < NCB; ++c) tma_store(&to, qw + c * Q_BOX, c * BOX, q0 + wg * 64, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A (batch, heads, seq, D) bf16 view with element strides st = (batch, head,
// seq) and a unit last stride, cut in boxes of 64 columns x `rows` rows.
bool encode(CUtensorMap* map, const void* base, int64_t B, int64_t heads, int64_t S, int64_t D,
            const int64_t* st, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory: 1 KB of alignment slack, the Q tile, the K/V ring,
// the barriers
template <int NCB>
constexpr size_t smem_bytes() {
  return 1024 + NCB * (BQ * 128 + 2 * STAGES * BKV * 128) + 8 * (1 + 2 * STAGES);
}

template <int NCB>
int launch(const CUtensorMap* maps, int64_t B, int64_t H, int64_t KV, int64_t sq, int64_t sk,
           float scale, int causal, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<NCB>();
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<NCB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  dim3 grid((unsigned)(B * H), (unsigned)rt_cdiv(sq, BQ));
  flash_fwd_wgmma_kernel<NCB><<<grid, NT, bytes, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                      (int)H, (int)(H / KV), (int)sq, (int)sk,
                                                      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// float32: q, o (B, H, sq, D) contiguous; k, v (B, KV, sk, D) contiguous, KV | H.
RT_EXPORT int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                 int64_t B, int64_t H, int64_t KV, int64_t sq, int64_t sk,
                                 int64_t D, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || sq < 1 || sk < 1 || B * H > 65535 ||
      rt_cdiv(sq, simt::BQ) > 2147483647)
    return RT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return simt::launch<16>(q, k, v, o, B, H, KV, sq, sk, scale, causal, s);
    case 32: return simt::launch<32>(q, k, v, o, B, H, KV, sq, sk, scale, causal, s);
    case 64: return simt::launch<64>(q, k, v, o, B, H, KV, sq, sk, scale, causal, s);
    case 96: return simt::launch<96>(q, k, v, o, B, H, KV, sq, sk, scale, causal, s);
    case 128: return simt::launch<128>(q, k, v, o, B, H, KV, sq, sk, scale, causal, s);
    default: return RT_BAD_ARGUMENT;
  }
}

// bfloat16: q, o (B, H, sq, D) and k, v (B, KV, sk, D), KV | H, D a multiple
// of 8 up to 128, unit last strides; `strides` holds the (batch, head, seq)
// element strides of q, k, v and o in that order.  Bases and strides must be
// multiples of 16 bytes.
RT_EXPORT int rt_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                      const int64_t* strides, int64_t B, int64_t H, int64_t KV,
                                      int64_t sq, int64_t sk, int64_t D, float scale,
                                      int causal, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || sq < 1 || sk < 1 || D < 8 || D > 128 || D % 8 ||
      B * H > 2147483647 || rt_cdiv(sq, hopper::BQ) > 65535 || sq > 2147483647 ||
      sk > 2147483647)
    return RT_BAD_ARGUMENT;
  const void* base[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    if ((uintptr_t)base[i] % 16) return RT_BAD_ARGUMENT;
    for (int j = 0; j < 3; ++j)
      if ((strides[3 * i + j] * 2) % 16 || strides[3 * i + j] < 0) return RT_BAD_ARGUMENT;
  }
  CUtensorMap maps[4];
  if (!hopper::encode(&maps[0], q, B, H, sq, D, strides, hopper::BQ) ||
      !hopper::encode(&maps[1], k, B, KV, sk, D, strides + 3, hopper::BKV) ||
      !hopper::encode(&maps[2], v, B, KV, sk, D, strides + 6, hopper::BKV) ||
      !hopper::encode(&maps[3], o, B, H, sq, D, strides + 9, 64))
    return RT_TMA_REFUSED;
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? hopper::launch<1>(maps, B, H, KV, sq, sk, scale, causal, s)
                 : hopper::launch<2>(maps, B, H, KV, sq, sk, scale, causal, s);
}

// the bfloat16 kernel's dynamic shared memory per CTA at head dim D
RT_EXPORT int rt_flash_attention_bf16_smem(int64_t D) {
  return (int)(D <= 64 ? hopper::smem_bytes<1>() : hopper::smem_bytes<2>());
}
