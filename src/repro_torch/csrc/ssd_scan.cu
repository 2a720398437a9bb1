// K8 — the Mamba2 SSD intra-chunk kernel: per (batch, chunk) and head, the
// cumsum of the log-decays, the dual matrix C B^T, the causal decays
// exp(cum_i - cum_j) for i >= j, y_intra = (C B^T o L_h) x_h and the chunk's
// input state x_h^T (B o exp(cum_last - cum)).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (pallas_call at ssd_scan.py:62, body _ssd_kernel).  The TPU grid has one
// cell per (batch, chunk) that walks every head; here one CTA owns a
// (batch, chunk, group of heads), so a prefill of one sequence still fills
// the card (the host picks the group so that the grid holds about one wave
// of resident CTAs).  C B^T is computed once per CTA and never leaves the
// chip, which is the point of the TPU kernel; each head masks it with its
// decays (mask before the exp: exp of a positive difference overflows to
// inf, and inf * 0 is NaN) and multiplies.
//
// What it computes, as _ssd_kernel: cum by a sequential float32 sum over
// the chunk, as jnp.cumsum; y_intra rounded once to the input type; states
// and cum written in float32.  The last chunk may be ragged: the entry takes
// the true length L, rows past it read as a = 0, x = B = C = 0 (the glue's
// exact end pad) and no y or cum row past L is written, so the SSD scan
// passes its unpadded tensors.  B and C may be row-strided (slices of the
// model's xBC projection).
//
// Bound on an H100: bytes.  At the prefill shape (1, 2048, 32 x 64), N 128,
// chunk 64, bf16 x/B/C and float32 a, the kernel reads 9.7 MB and writes
// 42.2 MB (the float32 states are 33.6 MB of it): 0.0155 ms at 3.35 TB/s,
// against 1.36 GFLOP of products, 0.0014 ms at the bf16 tensor-core peak.
// Two instances:
//
// * bfloat16 (ssd_intra_tc_kernel): the three products on the tensor cores,
//   mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix from shared memory, four
//   warps, each owning 16 rows of a product.  C B^T takes the bf16 inputs as
//   they are and stays in registers as accumulator fragments, which are
//   laid out as the A operand of the next product, so M_h = C B^T o L_h is
//   formed in registers.  The other two products have a float32 left
//   operand (M_h, and x_h^T scaled by the decays): it is split into
//   hi = bf16(v) and lo = bf16(v - hi) and multiplied twice against the
//   exact bf16 right operand (x_h, B), which keeps about 2^-16 of relative
//   precision: y_intra still rounds once, and the states keep the float32
//   tolerance.  The next head's x tile arrives by cp.async under the current
//   head's products.  The states leave through a per-warp stage in shared
//   memory as coalesced 16-byte stores, so the 33.6 MB the bound is made of
//   go out in whole rows.  Each head's decays exp(cum_last - cum_j) are
//   computed once into shared memory.  Shared memory (72 KB with 3 heads a
//   CTA) and registers let three CTAs share an SM.  The products are not
//   what is left between this kernel and its bound: the preparation of the
//   states' operands and their stage-out are (benchmarks_torch/ssd_ablate.py
//   switches the parts off one at a time; PERF.md keeps the readings).
// * float32 (ssd_intra_simt_kernel): the first version of K8, kept for
//   float32 inputs (the JAX kernel test's): everything in float32 on the
//   CUDA cores, B, C and x staged in shared memory as float32 with rows
//   padded by one word, 4 x 4 (C B^T, y) or 4 x 8 (states) register tiles.
#include <math.h>

#include "rt_common.cuh"

namespace {

constexpr int QM = 64;        // largest chunk
constexpr int NM = 128;       // largest d_state
constexpr int PM = 64;        // largest headdim
constexpr int MAX_GROUP = 32; // heads per CTA at most (bounds shared memory)

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NT = 128;        // four warps
constexpr int LDK = NM + 8;    // bf16 row stride of the B and C tiles (272 bytes)
constexpr int LDX = PM + 8;    // bf16 row stride of the x tiles (144 bytes)
constexpr int LDO = 64 + 8;    // float row stride of a warp's output stage (64 columns)

constexpr size_t smem_bytes(int group) {
  return (2 * (size_t)QM * LDK + 2 * (size_t)QM * LDX) * 2 +
         (4 * 16 * (size_t)LDO + 2 * (size_t)group * QM) * 4;
}

// rows [0, rows_pad) x columns [0, cols_pad) of a bf16 tile (at most MAXC
// columns) from global rows `src + r * ld`: rows < nv and columns < cols are
// copied, the rest zeroed.  vec: 16-byte cp.async, a fixed column a thread
// (cols, ld and the base are multiples of 8 elements); else one element at
// a time.
template <int MAXC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int lds, const __nv_bfloat16* src,
                                          int64_t ld, int rows_pad, int nv, int cols_pad,
                                          int cols, bool vec, int tid) {
  if (vec) {
    constexpr int CPR = MAXC / 8;     // copies a row
    const int q = (tid % CPR) * 8;
    if (q < cols_pad)
      for (int r = tid / CPR; r < rows_pad; r += NT / CPR) {
        const bool valid = r < nv && q < cols;
        rt_cp_async16(dst + r * lds + q, valid ? src + r * ld + q : src, valid);
      }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < rows_pad * cols_pad; idx += NT) {
      const int r = idx / cols_pad, q = idx % cols_pad;
      dst[r * lds + q] = (r < nv && q < cols) ? src[r * ld + q] : zero;
    }
  }
}

// M = C B^T o L: masked before the exp
__device__ __forceinline__ float masked(int i, int j, float cb, float ci, float cj) {
  return j <= i ? cb * expf(ci - cj) : 0.f;
}

// x, y: (B, L, H*P) contiguous; a, cum: (B, L, H) float32; Bm, Cm: rows of
// N at strides ldb, ldc; st: (B, nc, H*P, N) float32.  grid (nc, head
// groups, B).
__global__ void __launch_bounds__(NT, 3)
ssd_intra_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ st,
                    float* __restrict__ cum_out, int L, int nc, int Q, int H, int P, int N, int G,
                    int64_t ldb, int64_t ldc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);  // QM x LDK
  __nv_bfloat16* Cs = Bs + QM * LDK;                            // QM x LDK
  __nv_bfloat16* Xs = Cs + QM * LDK;                            // 2 x QM x LDX
  float* stage = reinterpret_cast<float*>(Xs + 2 * QM * LDX);   // 4 warps x 16 x LDO
  float* cum = stage + 4 * 16 * LDO;                            // G x QM
  float* dec = cum + G * QM;                  // G x QM: exp(cum_last - cum_j)

  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * G;
  const int gn = H - h0 < G ? H - h0 : G;
  const int nv = L - c * Q < Q ? L - c * Q : Q;     // rows of this chunk below L
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int64_t HP = (int64_t)H * P;
  const int QP = (Q + 15) & ~15, NP = (N + 15) & ~15, PP = (P + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = lane >> 2, cq = (lane & 3) * 2;   // fragment row and column pair

  load_tile<NM>(Bs, LDK, Bm + row0 * ldb, ldb, QP, nv, NP, N, vec, tid);
  load_tile<NM>(Cs, LDK, Cm + row0 * ldc, ldc, QP, nv, NP, N, vec, tid);
  load_tile<PM>(Xs, LDX, x + row0 * HP + (int64_t)h0 * P, HP, QP, nv, PP, P, vec, tid);
  rt_cp_async_commit();
  for (int idx = tid; idx < QP * gn; idx += NT) {
    const int j = idx / gn, g = idx % gn;
    cum[g * QM + j] = j < nv ? a[(row0 + j) * H + h0 + g] : 0.f;
  }
  rt_cp_async_wait<0>();
  __syncthreads();
  if (tid < gn) {       // one thread per head sums its decays in order
    float* cg = cum + tid * QM;
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < QP; ++j) {
      s += cg[j];
      cg[j] = s;
      if (j < nv) cum_out[(row0 + j) * H + h0 + tid] = s;
    }
  }

  // C B^T for the warp's 16 rows, the column tiles up to the diagonal
  float cb[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[t][e] = 0.f;
  if (16 * warp < QP) {
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t af[4];
      rt_ldsm_x4(af, Cs + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK + 16 * kk +
                         (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj > warp) continue;
        uint32_t bf[4];
        rt_ldsm_x4(bf, Bs + (16 * jj + (lane & 7) + (lane >> 4) * 8) * LDK + 16 * kk +
                           ((lane >> 3) & 1) * 8);
        rt_mma_bf16(cb[2 * jj], af, bf[0], bf[1]);
        rt_mma_bf16(cb[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
  }
  __syncthreads();      // the cumsums are summed
  for (int idx = tid; idx < QP * gn; idx += NT) {   // each head's decays, once
    const int g = idx / QP, j = idx % QP;
    dec[g * QM + j] = expf(cum[g * QM + Q - 1] - cum[g * QM + j]);
  }
  __syncthreads();

  float* stg = stage + warp * 16 * LDO;
  for (int g = 0; g < gn; ++g) {
    const int h = h0 + g;
    const __nv_bfloat16* xs = Xs + (g & 1) * QM * LDX;
    if (g + 1 < gn)     // the next head's x under this head's products
      load_tile<PM>(Xs + ((g + 1) & 1) * QM * LDX, LDX, x + row0 * HP + (int64_t)(h + 1) * P, HP,
                QP, nv, PP, P, vec, tid);
    rt_cp_async_commit();
    const float* cg = cum + g * QM;

    // y_h = M_h x_h over the warp's rows i, k tiles j up to the diagonal
    if (16 * warp < QP) {
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      const int i0 = 16 * warp + r0, i1 = i0 + 8;
      const float ci0 = cg[i0], ci1 = cg[i1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) continue;
        const int j0 = 16 * kk + cq;
        const float cj0 = cg[j0], cj1 = cg[j0 + 1], cj8 = cg[j0 + 8], cj9 = cg[j0 + 9];
        const float* lo_t = cb[2 * kk];
        const float* hi_t = cb[2 * kk + 1];
        uint32_t ah[4], al[4];
        rt_split_bf16(masked(i0, j0, lo_t[0], ci0, cj0), masked(i0, j0 + 1, lo_t[1], ci0, cj1),
                      ah[0], al[0]);
        rt_split_bf16(masked(i1, j0, lo_t[2], ci1, cj0), masked(i1, j0 + 1, lo_t[3], ci1, cj1),
                      ah[1], al[1]);
        rt_split_bf16(masked(i0, j0 + 8, hi_t[0], ci0, cj8),
                      masked(i0, j0 + 9, hi_t[1], ci0, cj9), ah[2], al[2]);
        rt_split_bf16(masked(i1, j0 + 8, hi_t[2], ci1, cj8),
                      masked(i1, j0 + 9, hi_t[3], ci1, cj9), ah[3], al[3]);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (16 * pp >= PP) continue;
          uint32_t bf[4];
          rt_ldsm_x4_t(bf, xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX + 16 * pp +
                               (lane >> 4) * 8);
          rt_mma_bf16(acc[2 * pp], ah, bf[0], bf[1]);
          rt_mma_bf16(acc[2 * pp], al, bf[0], bf[1]);
          rt_mma_bf16(acc[2 * pp + 1], ah, bf[2], bf[3]);
          rt_mma_bf16(acc[2 * pp + 1], al, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (8 * t >= PP) continue;
        *reinterpret_cast<float2*>(stg + r0 * LDO + 8 * t + cq) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(stg + (r0 + 8) * LDO + 8 * t + cq) =
            make_float2(acc[t][2], acc[t][3]);
      }
      __syncwarp();
      const int rows = nv - 16 * warp < 16 ? nv - 16 * warp : 16;
      __nv_bfloat16* yd = y + (row0 + 16 * warp) * HP + (int64_t)h * P;
      if (vec) {        // 8 values = 16 bytes a lane, 4 rows a step
        const int q = (lane & 7) * 8;
        for (int r = lane >> 3; r < rows && q < P; r += 4) {
          const float4 u = *reinterpret_cast<const float4*>(stg + r * LDO + q);
          const float4 v = *reinterpret_cast<const float4*>(stg + r * LDO + q + 4);
          *reinterpret_cast<uint4*>(yd + r * HP + q) =
              make_uint4(rt_pack_bf16x2(u.x, u.y), rt_pack_bf16x2(u.z, u.w),
                         rt_pack_bf16x2(v.x, v.y), rt_pack_bf16x2(v.z, v.w));
        }
      } else {
        for (int idx = lane; idx < rows * P; idx += 32) {
          const int r = idx / P, q = idx % P;
          yd[r * HP + q] = __float2bfloat16(stg[r * LDO + q]);
        }
      }
      __syncwarp();
    }

    // st_h = (x_h o decay)^T B over the warp's 16 rows p, all columns n
    if (16 * warp < PP) {
      const int p0 = 16 * warp;
      const float* dg = dec + g * QM;  // cum_last = cum[nv - 1]: the pad rows add a = 0
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= QP) continue;
        uint32_t xf[4];       // (x^T) rows p, columns j: transposed x tile
        rt_ldsm_x4_t(xf, xs + (16 * kk + (lane & 7) + (lane >> 4) * 8) * LDX + p0 +
                             ((lane >> 3) & 1) * 8);
        const int j0 = 16 * kk + cq;
        const float d0 = dg[j0], d1 = dg[j0 + 1], d8 = dg[j0 + 8], d9 = dg[j0 + 9];
        float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xf[0]));
        rt_split_bf16(v.x * d0, v.y * d1, ah[kk][0], al[kk][0]);
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xf[1]));
        rt_split_bf16(v.x * d0, v.y * d1, ah[kk][1], al[kk][1]);
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xf[2]));
        rt_split_bf16(v.x * d8, v.y * d9, ah[kk][2], al[kk][2]);
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xf[3]));
        rt_split_bf16(v.x * d8, v.y * d9, ah[kk][3], al[kk][3]);
      }
      float acc[16][4];
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        if (16 * nn >= NP) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (16 * kk >= QP) continue;
          uint32_t bf[4];
          rt_ldsm_x4_t(bf, Bs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK + 16 * nn +
                               (lane >> 4) * 8);
          rt_mma_bf16(acc[2 * nn], ah[kk], bf[0], bf[1]);
          rt_mma_bf16(acc[2 * nn], al[kk], bf[0], bf[1]);
          rt_mma_bf16(acc[2 * nn + 1], ah[kk], bf[2], bf[3]);
          rt_mma_bf16(acc[2 * nn + 1], al[kk], bf[2], bf[3]);
        }
      }
      const int rows = P - p0 < 16 ? P - p0 : 16;
      float* sd = st + (((int64_t)b * nc + c) * HP + (int64_t)h * P + p0) * N;
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {   // 64 columns of n at a time
        if (64 * hn >= NP) continue;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (64 * hn + 8 * t >= NP) continue;
          const float* at = acc[8 * hn + t];
          *reinterpret_cast<float2*>(stg + r0 * LDO + 8 * t + cq) = make_float2(at[0], at[1]);
          *reinterpret_cast<float2*>(stg + (r0 + 8) * LDO + 8 * t + cq) =
              make_float2(at[2], at[3]);
        }
        __syncwarp();
        const int n0 = 64 * hn, nw = N - n0 < 64 ? N - n0 : 64;
        if (vec) {      // rows of 64 floats, 16 bytes a lane, 2 rows a step
          const int q = (lane & 15) * 4;
          for (int r = lane >> 4; r < rows && q < nw; r += 2)
            *reinterpret_cast<float4*>(sd + (int64_t)r * N + n0 + q) =
                *reinterpret_cast<const float4*>(stg + r * LDO + q);
        } else {
          for (int idx = lane; idx < rows * nw; idx += 32) {
            const int r = idx / nw, q = idx % nw;
            sd[(int64_t)r * N + n0 + q] = stg[r * LDO + q];
          }
        }
        __syncwarp();
      }
    }
    rt_cp_async_wait<0>();
    __syncthreads();    // the next head's x has landed; this head's is spent
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int NT = 256;       // threads: 16 x 16
constexpr int LDN = NM + 1;   // row stride of the B and C tiles
constexpr int LDQ = QM + 1;   // row stride of the chunk x chunk tiles

constexpr size_t smem_floats(int group) {
  return 2 * (size_t)QM * LDN + 2 * (size_t)QM * LDQ + QM + (size_t)group * QM;
}

// as tc::ssd_intra_tc_kernel, float32 throughout.  grid (nc, head groups, B).
__global__ void __launch_bounds__(NT)
ssd_intra_simt_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      float* __restrict__ y, float* __restrict__ st, float* __restrict__ cum_out,
                      int L, int nc, int Q, int H, int P, int N, int G, int64_t ldb,
                      int64_t ldc) {
  extern __shared__ float smem[];
  float* Bs = smem;               // Q x LDN: B, all heads
  float* cx = Bs + QM * LDN;      // Q x LDN: C, then each head's x (Q x PM)
  float* cb = cx + QM * LDN;      // Q x LDQ: C B^T
  float* ms = cb + QM * LDQ;      // Q x LDQ: this head's masked C B^T o L_h
  float* dec = ms + QM * LDQ;     // Q: exp(cum_last - cum_j), this head
  float* cum = dec + QM;          // G x QM: the group's cumsums

  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * G;
  const int gn = H - h0 < G ? H - h0 : G;
  const int nv = L - c * Q < Q ? L - c * Q : Q;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int64_t HP = (int64_t)H * P;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // stage the group's decays, B and C (zeros past L); then one thread per
  // head sums its decays in order while the others compute C B^T
  for (int idx = tid; idx < Q * gn; idx += NT) {
    const int j = idx / gn, g = idx % gn;
    cum[g * QM + j] = j < nv ? a[(row0 + j) * H + h0 + g] : 0.f;
  }
  for (int idx = tid; idx < Q * N; idx += NT) {
    const int j = idx / N, n = idx % N;
    Bs[j * LDN + n] = j < nv ? Bm[(row0 + j) * ldb + n] : 0.f;
    cx[j * LDN + n] = j < nv ? Cm[(row0 + j) * ldc + n] : 0.f;
  }
  __syncthreads();
  if (tid < gn) {
    float* cg = cum + tid * QM;
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < Q; ++j) {
      s += cg[j];
      cg[j] = s;
      if (j < nv) cum_out[(row0 + j) * H + h0 + tid] = s;
    }
  }

  // C B^T over rows ty*4 + i, columns tx + 16*j (rows and columns past Q
  // read stale tiles and are never used)
  {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cx[(ty * 4 + i) * LDN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[(ty * 4 + i) * LDQ + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();   // C is spent (the x tiles take its place); cum is summed

  for (int g = 0; g < gn; ++g) {
    const int h = h0 + g;
    const float* cg = cum + g * QM;
    for (int idx = tid; idx < Q * P; idx += NT) {
      const int j = idx / P, p = idx % P;
      cx[j * PM + p] = j < nv ? x[(row0 + j) * HP + (int64_t)h * P + p] : 0.f;
    }
    for (int idx = tid; idx < Q * Q; idx += NT) {
      const int i = idx / Q, j = idx % Q;
      ms[i * LDQ + j] = i >= j ? cb[i * LDQ + j] * expf(cg[i] - cg[j]) : 0.f;
    }
    if (tid < Q) dec[tid] = expf(cg[Q - 1] - cg[tid]);
    __syncthreads();

    // y_h = M_h x_h: rows i = ty*4 + ii, columns p = tx + 16*jj
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        float mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = ms[(ty * 4 + i) * LDQ + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = cx[j * PM + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(mv[i], xv[k], acc[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nv) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (p < P) y[(row0 + r) * HP + (int64_t)h * P + p] = acc[i][k];
        }
      }
    }
    // st_h = x_h^T (B o dec): rows p = ty*4 + ii, columns n = tx + 16*jj
    {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
#pragma unroll 2
      for (int j = 0; j < Q; ++j) {
        const float d = dec[j];
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = cx[j * PM + ty * 4 + i] * d;
#pragma unroll
        for (int k = 0; k < 8; ++k) bv[k] = Bs[j * LDN + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(xv[i], bv[k], acc[i][k]);
      }
      float* sp = st + (((int64_t)b * nc + c) * HP + (int64_t)h * P) * N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty * 4 + i;
        if (p >= P) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = tx + 16 * k;
          if (n < N) sp[(int64_t)p * N + n] = acc[i][k];
        }
      }
    }
    __syncthreads();   // the next head overwrites x, M and the decays
  }
}

}  // namespace simt

// heads per CTA: about `slots` CTAs over the card, at most MAX_GROUP heads each
int64_t group_size(int64_t B, int64_t nc, int64_t H, int64_t slots) {
  int64_t groups = rt_cdiv(slots, B * nc);
  if (groups > H) groups = H;
  if (groups < rt_cdiv(H, MAX_GROUP)) groups = rt_cdiv(H, MAX_GROUP);
  return rt_cdiv(H, groups);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// x, y: (B, L, H*P) contiguous; a, cum: (B, L, H) float32; Bm, Cm: (B, L, N)
// of x's type with rows at strides ldb, ldc elements (batch stride L * ld);
// st: (B, cdiv(L, Q), H*P, N) float32.  L need not divide by Q.
RT_EXPORT int rt_ssd_intra_chunk(const void* x, const void* a, const void* Bm, const void* Cm,
                                 void* y, void* st, void* cum, int64_t B, int64_t L, int64_t Q,
                                 int64_t H, int64_t P, int64_t N, int64_t ldb, int64_t ldc,
                                 int dtype, void* stream) {
  if (B < 1 || L < 1 || H < 1 || Q < 1 || Q > QM || P < 1 || P > PM || N < 1 || N > NM ||
      ldb < N || ldc < N || B > 65535 || B * L > 2147483647 || H * P > 2147483647)
    return RT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nc = rt_cdiv(L, Q);
  if (dtype == DT_BF16) {
    static bool opted_in = false;   // above 48 KB only after opting in, once
    if (!opted_in) {
      cudaError_t err = cudaFuncSetAttribute(tc::ssd_intra_tc_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)tc::smem_bytes(MAX_GROUP));
      if (err != cudaSuccess) return (int)err;
      opted_in = true;
    }
    const int vec = P % 8 == 0 && N % 8 == 0 && ldb % 8 == 0 && ldc % 8 == 0 && aligned16(x) &&
                    aligned16(Bm) && aligned16(Cm) && aligned16(y) && aligned16(st);
    const int64_t G = group_size(B, nc, H, 396);   // three resident CTAs an SM
    dim3 grid((unsigned)nc, (unsigned)rt_cdiv(H, G), (unsigned)B);
    tc::ssd_intra_tc_kernel<<<grid, tc::NT, tc::smem_bytes((int)G), s>>>(
        (const __nv_bfloat16*)x, (const float*)a, (const __nv_bfloat16*)Bm,
        (const __nv_bfloat16*)Cm, (__nv_bfloat16*)y, (float*)st, (float*)cum, (int)L, (int)nc,
        (int)Q, (int)H, (int)P, (int)N, (int)G, ldb, ldc, vec);
    return (int)cudaGetLastError();
  }
  if (dtype == DT_F32) {
    static bool opted_in = false;
    if (!opted_in) {
      cudaError_t err = cudaFuncSetAttribute(simt::ssd_intra_simt_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)(simt::smem_floats(MAX_GROUP) * sizeof(float)));
      if (err != cudaSuccess) return (int)err;
      opted_in = true;
    }
    const int64_t G = group_size(B, nc, H, 264);
    dim3 grid((unsigned)nc, (unsigned)rt_cdiv(H, G), (unsigned)B);
    simt::ssd_intra_simt_kernel<<<grid, simt::NT, simt::smem_floats((int)G) * sizeof(float), s>>>(
        (const float*)x, (const float*)a, (const float*)Bm, (const float*)Cm, (float*)y,
        (float*)st, (float*)cum, (int)L, (int)nc, (int)Q, (int)H, (int)P, (int)N, (int)G, ldb,
        ldc);
    return (int)cudaGetLastError();
  }
  return RT_BAD_ARGUMENT;
}
