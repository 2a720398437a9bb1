// K8 — the Mamba2 SSD intra-chunk kernel: per (batch, chunk) and head, the
// cumsum of the log-decays, the dual matrix C B^T, the causal decays
// exp(cum_i - cum_j) for i >= j, y_intra = (C B^T o L_h) x_h and the chunk's
// input state x_h^T (B o exp(cum_last - cum)).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (pallas_call at ssd_scan.py:62, body _ssd_kernel).  The TPU grid has one
// cell per (batch, chunk) that walks every head; here one CTA owns a
// (batch, chunk, group of heads), so a prefill of one sequence still fills
// the card (the host picks the group so that the grid holds about two waves
// of CTAs).  C B^T is computed once per CTA into shared memory and never
// leaves the chip, which is the point of the TPU kernel; each head then masks
// it with its decays (mask before the exp: exp of a positive difference
// overflows to inf, and inf * 0 is NaN) into a second tile and multiplies.
//
// What it computes, as _ssd_kernel: everything in float32; cum by a
// sequential sum over the chunk, as jnp.cumsum; y_intra rounded once to the
// input type; states and cum written in float32.  B, C and x are staged in
// shared memory as float32, rows padded by one word where a column walk
// would hit one bank.  Each thread owns a 4 x 4 (C B^T, y) or 4 x 8 (states)
// register tile, so a product reads one operand from shared memory for every
// two to three FMAs.
//
// Bound on an H100: bytes.  At the prefill shape (1, 2048, 32 x 64), N 128,
// chunk 64, bf16 x/B/C and float32 a, the kernel reads 9.7 MB and writes
// 42.2 MB (the float32 states are 33.6 MB of it): 0.0155 ms at 3.35 TB/s,
// against 1.36 GFLOP of products (the causal pairs of C B^T and of y, all of
// the states), 0.0014 ms at the bf16 tensor-core peak.
// This first version computes on the CUDA cores in float32 and writes the
// states straight from registers, coalesced along N; wgmma, TMA and a bf16
// data path are later work.
#include <math.h>

#include "rt_common.cuh"

namespace {

constexpr int QM = 64;        // largest chunk
constexpr int NM = 128;       // largest d_state
constexpr int PM = 64;        // largest headdim
constexpr int NT = 256;       // threads: 16 x 16
constexpr int LDN = NM + 1;   // row stride of the B and C tiles
constexpr int LDQ = QM + 1;   // row stride of the chunk x chunk tiles
constexpr int MAX_GROUP = 32; // heads per CTA at most (bounds shared memory)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t smem_floats(int group) {
  return 2 * (size_t)QM * LDN + 2 * (size_t)QM * LDQ + QM + (size_t)group * QM;
}

// x, y: (B, L, H*P); a, cum: (B, L, H) float32; Bm, Cm: (B, L, N);
// st: (B, nc, H*P, N) float32.  grid (nc, head groups, B).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ cum_out, int nc, int Q, int H,
                 int P, int N, int G) {
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
  const int64_t row0 = ((int64_t)b * nc + c) * Q;   // the chunk's first row
  const int64_t HP = (int64_t)H * P;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // stage the group's decays, B and C; then one thread per head sums its
  // decays in order while the others compute C B^T
  for (int idx = tid; idx < Q * gn; idx += NT) {
    const int j = idx / gn, g = idx % gn;
    cum[g * QM + j] = a[(row0 + j) * H + h0 + g];
  }
  for (int idx = tid; idx < Q * N; idx += NT) {
    const int j = idx / N, n = idx % N;
    Bs[j * LDN + n] = to_f32(Bm[(row0 + j) * N + n]);
    cx[j * LDN + n] = to_f32(Cm[(row0 + j) * N + n]);
  }
  __syncthreads();
  if (tid < gn) {
    float* cg = cum + tid * QM;
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < Q; ++j) {
      s += cg[j];
      cg[j] = s;
      cum_out[(row0 + j) * H + h0 + tid] = s;
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
      cx[j * PM + p] = to_f32(x[(row0 + j) * HP + (int64_t)h * P + p]);
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
        if (r >= Q) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (p < P) y[(row0 + r) * HP + (int64_t)h * P + p] = from_f32<T>(acc[i][k]);
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

template <typename T>
int launch(const void* x, const float* a, const void* Bm, const void* Cm, void* y, float* st,
           float* cum, int64_t B, int64_t nc, int64_t Q, int64_t H, int64_t P, int64_t N,
           cudaStream_t s) {
  static bool opted_in = false;   // above 48 KB only after opting in, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(ssd_intra_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)(smem_floats(MAX_GROUP) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  // head groups: about two waves of CTAs over the 132 SMs, at most MAX_GROUP
  // heads per CTA
  int64_t groups = rt_cdiv(264, B * nc);
  if (groups > H) groups = H;
  if (groups < rt_cdiv(H, MAX_GROUP)) groups = rt_cdiv(H, MAX_GROUP);
  const int64_t G = rt_cdiv(H, groups);
  groups = rt_cdiv(H, G);
  dim3 grid((unsigned)nc, (unsigned)groups, (unsigned)B);
  ssd_intra_kernel<T><<<grid, NT, smem_floats((int)G) * sizeof(float), s>>>(
      (const T*)x, a, (const T*)Bm, (const T*)Cm, (T*)y, st, cum, (int)nc, (int)Q, (int)H,
      (int)P, (int)N, (int)G);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, nc*Q, H*P) contiguous; a, cum: (B, nc*Q, H) float32; Bm, Cm:
// (B, nc*Q, N) of x's type; st: (B, nc, H*P, N) float32.
RT_EXPORT int rt_ssd_intra_chunk(const void* x, const void* a, const void* Bm, const void* Cm,
                                 void* y, void* st, void* cum, int64_t B, int64_t nc,
                                 int64_t Q, int64_t H, int64_t P, int64_t N, int dtype,
                                 void* stream) {
  if (B < 1 || nc < 1 || H < 1 || Q < 1 || Q > QM || P < 1 || P > PM || N < 1 || N > NM ||
      B > 65535 || nc > 2147483647 || H * P > 2147483647)
    return RT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch<float>(x, (const float*)a, Bm, Cm, y, (float*)st, (float*)cum, B, nc, Q,
                           H, P, N, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(x, (const float*)a, Bm, Cm, y, (float*)st, (float*)cum, B,
                                   nc, Q, H, P, N, s);
    default: return RT_BAD_ARGUMENT;
  }
}
