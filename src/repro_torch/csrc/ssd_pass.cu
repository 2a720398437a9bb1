// The SSD state pass and read-out: the inter-chunk half of the Mamba2 SSD
// scan, after K8.  For every (batch, head) it walks the chunks in order,
// carrying the state entering each chunk:
//
//   y[t]   = T(y_intra[t]) + T(exp(cum_t) * C_t . carry)   (t in chunk c)
//   carry  = carry * exp(cum_last(c)) + states[c]
//
// and writes the final carry as the scan's final state.
//
// Replaces the XLA glue around the TPU kernel K8:
// repro/kernels/ops.py::ssd_scan, lines 39-63 — the lax.scan over the chunk
// states and the einsum read-out.  That glue has no pallas_call; this is its
// device counterpart, so the SSD scan is two launches (K8, then this) with
// no pad and no per-chunk operator.  What it computes, as the glue: the
// carry in float32 starting from the initial state (or zeros); y_intra and
// y_inter each rounded to the input type before they are added
// (ops.py:60-62); the final state in the input type.  The last chunk may be
// ragged: rows past L read C = 0, and exp(cum_last) is the decay to the last
// row below L (the pad rows add a = 0), so no input is padded and no y row
// past L is written.
//
// One CTA of eight warps owns one (batch, head, tile of 16 headdim rows): at
// the mamba2-370m prefill (1, 2040, 32 x 64, N 128) that is 128 CTAs, one an
// SM, so the walk's latency is hidden by warps, not by CTAs.  Warp w reads
// out chunk rows 16 (w % 4) .. + 15 against headdim rows 8 (w / 4) .. + 7:
// y_inter = C (16 x N) . carry^T on the tensor cores.  C is exact in bf16;
// the float32 carry is split into hi = bf16(v) and lo = bf16(v - hi) and
// multiplied twice (about 2^-16 relative).  float32 inputs split C as well
// and add the third product lo(C) . hi(carry).  Each thread owns 8 elements
// of the float32 carry in registers, updates them and publishes their hi
// and lo parts to shared memory once a chunk, where every warp reads its
// B operand by ldmatrix, so no warp splits what another already has.  Each
// chunk's state tile, C rows, y_intra rows and cumsums arrive by cp.async
// into a ring of stages, five (bf16) or three (float32) chunks ahead of the
// walk.
//
// Bound on an H100: bytes.  At the prefill shape it reads the float32 states
// (33.6 MB), y_intra (8.4 MB), C (0.5 MB), the cumsums (0.26 MB) and the
// initial state, and writes y (8.4 MB) and the final state: about 52 MB,
// 0.0155 ms at 3.35 TB/s, against 1.1 GFLOP of read-out products.  It does
// not reach that: with one CTA an SM the walk is bound by the latency of
// each chunk's step (the copies' issue and the read-out each add about as
// much as the other: PERF.md §6 keeps the readings with each part switched
// off in turn, and the designs tried).
#include <math.h>

#include "rt_common.cuh"

namespace {

constexpr int QM = 64;        // largest chunk
constexpr int NM = 128;       // largest d_state
constexpr int PT = 16;        // headdim rows per CTA
constexpr int NT = 256;       // eight warps: 4 tiles of chunk rows x 2 halves of PT
constexpr int LDS = NM + 8;   // float row stride of the state tile
constexpr int LDH = NM + 8;   // bf16 row stride of the carry's hi and lo parts

template <typename T>
struct Stage {
  static constexpr int E = 16 / (int)sizeof(T);   // elements a 16-byte copy
  static constexpr int LDC = NM + 8;               // row stride of the C rows
  static constexpr int LDY = PT + E;               // row stride of the y_intra rows
  static constexpr size_t ST = (size_t)PT * LDS * 4;
  static constexpr size_t C = (size_t)QM * LDC * sizeof(T);
  static constexpr size_t Y = (size_t)QM * LDY * sizeof(T);
  static constexpr size_t BYTES = ST + C + Y + QM * 4;
  // chunks in flight: the one read out and the rest ahead, as many as fit
  static constexpr int STAGES = sizeof(T) == 2 ? 6 : 4;
};

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

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// chunk c's state tile (16 x N), C rows, y_intra rows (chunk x 16) and
// cumsums into stage `sb`: rows past L, columns past N and headdim rows past
// P read as zeros.  vec: 16-byte cp.async, a fixed column a thread; else one
// element at a time.
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* sb, const T* yi, const float* st,
                                           const float* cum, const T* Cm, int b, int h, int p0,
                                           int c, int L, int nc, int Q, int H, int P, int N,
                                           int64_t ldc, bool vec, int tid) {
  using S = Stage<T>;
  float* ss = reinterpret_cast<float*>(sb);
  T* cs = reinterpret_cast<T*>(sb + S::ST);
  T* ys = reinterpret_cast<T*>(sb + S::ST + S::C);
  float* us = reinterpret_cast<float*>(sb + S::ST + S::C + S::Y);
  const int nv = L - c * Q < Q ? L - c * Q : Q;
  const int QP = round16(Q), NP = round16(N);
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int64_t HP = (int64_t)H * P;
  const float* sg = st + (((int64_t)b * nc + c) * HP + (int64_t)h * P + p0) * N;
  const T* cg = Cm + row0 * ldc;
  const T* yg = yi + row0 * HP + (int64_t)h * P + p0;
  if (vec) {
    constexpr int SPR = NM / 4, CPR = NM / S::E, YPR = PT / S::E;   // copies a row
    const int qs = (tid % SPR) * 4, qc = (tid % CPR) * S::E, qy = (tid % YPR) * S::E;
    if (qs < NP)
      for (int r = tid / SPR; r < PT; r += NT / SPR) {
        const bool valid = p0 + r < P && qs < N;
        rt_cp_async16(ss + r * LDS + qs, valid ? sg + (int64_t)r * N + qs : st, valid);
      }
    if (qc < NP)
      for (int r = tid / CPR; r < QP; r += NT / CPR) {
        const bool valid = r < nv && qc < N;
        rt_cp_async16(cs + r * S::LDC + qc, valid ? cg + r * ldc + qc : Cm, valid);
      }
    for (int r = tid / YPR; r < QP; r += NT / YPR) {
      const bool valid = r < nv && p0 + qy < P;
      rt_cp_async16(ys + r * S::LDY + qy, valid ? yg + r * HP + qy : yi, valid);
    }
  } else {
    for (int idx = tid; idx < PT * NP; idx += NT) {
      const int r = idx / NP, q = idx % NP;
      ss[r * LDS + q] = (p0 + r < P && q < N) ? sg[(int64_t)r * N + q] : 0.f;
    }
    for (int idx = tid; idx < QP * NP; idx += NT) {
      const int r = idx / NP, q = idx % NP;
      cs[r * S::LDC + q] = from_f32<T>(r < nv && q < N ? to_f32(cg[r * ldc + q]) : 0.f);
    }
    for (int idx = tid; idx < QP * PT; idx += NT) {
      const int r = idx / PT, q = idx % PT;
      ys[r * S::LDY + q] = from_f32<T>(r < nv && p0 + q < P ? to_f32(yg[r * HP + q]) : 0.f);
    }
  }
  for (int r = tid; r < QP; r += NT)
    rt_cp_async4(us + r, r < nv ? cum + (row0 + r) * H + h : cum, r < nv);
}

// the A operand (16 chunk rows x 16 of N) of C: bf16 by ldmatrix as it is;
// float32 split into hi and lo
template <typename T>
__device__ __forceinline__ void c_fragment(const T* cs, int row, int col, int lane,
                                           uint32_t (&ah)[4], uint32_t (&al)[4]);
template <>
__device__ __forceinline__ void c_fragment<__nv_bfloat16>(const __nv_bfloat16* cs, int row,
                                                          int col, int lane, uint32_t (&ah)[4],
                                                          uint32_t (&al)[4]) {
  constexpr int LDC = Stage<__nv_bfloat16>::LDC;
  rt_ldsm_x4(ah, cs + (row + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC + col + (lane >> 4) * 8);
}
template <>
__device__ __forceinline__ void c_fragment<float>(const float* cs, int row, int col, int lane,
                                                  uint32_t (&ah)[4], uint32_t (&al)[4]) {
  constexpr int LDC = Stage<float>::LDC;
  const float* cr = cs + (row + (lane >> 2)) * LDC + col + (lane & 3) * 2;
  const float2 v0 = *reinterpret_cast<const float2*>(cr);
  const float2 v1 = *reinterpret_cast<const float2*>(cr + 8 * LDC);
  const float2 v2 = *reinterpret_cast<const float2*>(cr + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(cr + 8 * LDC + 8);
  rt_split_bf16(v0.x, v0.y, ah[0], al[0]);
  rt_split_bf16(v1.x, v1.y, ah[1], al[1]);
  rt_split_bf16(v2.x, v2.y, ah[2], al[2]);
  rt_split_bf16(v3.x, v3.y, ah[3], al[3]);
}

__device__ __forceinline__ float load_state(const void* s0, int64_t i, int dtype) {
  return dtype == DT_BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s0)[i])
                          : static_cast<const float*>(s0)[i];
}

// yi, y: (B, L, H*P); st: (B, nc, H*P, N) float32; cum: (B, L, H) float32;
// Cm: rows of N at stride ldc; s0 (B, H, P, N) of s0_dtype or null; fin:
// (B, H, P, N).  grid (cdiv(P, 16), H, B).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_pass_kernel(const T* __restrict__ yi, const float* __restrict__ st,
                const float* __restrict__ cum, const T* __restrict__ Cm, const void* s0,
                int s0_dtype, T* __restrict__ y, T* __restrict__ fin, int L, int nc, int Q, int H,
                int P, int N, int64_t ldc, int vec) {
  using S = Stage<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp & 3, jt = warp >> 2;         // chunk rows 16 mt.., tile rows 8 jt..
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  const int pr = p0 + 8 * jt + r0;                 // this thread's headdim row of the carry
  const int KT = round16(N) / 16;
  const int64_t HP = (int64_t)H * P;

  // the carry: row pr, columns n = 16kk + cq + {0, 1, 8, 9} of the warp's
  // two k tiles kk = 2 mt + i — each element held by one thread.  Its bf16
  // hi and lo parts go to shared memory (two buffers: the carry entering
  // the chunk read out, and the next), where every warp reads the B
  // operand of its read-out by ldmatrix.
  constexpr int STAGES = S::STAGES;
  __nv_bfloat16* hilo = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * S::BYTES);
  const int prow = 8 * jt + r0;                    // pr - p0
  float car[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * (2 * mt + i) + cq + (e & 1) + (e >> 1) * 8;
      car[i][e] = s0 != nullptr && pr < P && n < N
                      ? load_state(s0, (((int64_t)b * H + h) * P + pr) * N + n, s0_dtype)
                      : 0.f;
    }
  // hi and lo of the carry into buffer `buf`
  auto publish = [&](int buf) {
    __nv_bfloat16* hb = hilo + buf * 2 * PT * LDH + prow * LDH;
    __nv_bfloat16* lb = hb + PT * LDH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 16 * (2 * mt + i) + cq;
      uint32_t h01, l01, h89, l89;
      rt_split_bf16(car[i][0], car[i][1], h01, l01);
      rt_split_bf16(car[i][2], car[i][3], h89, l89);
      *reinterpret_cast<uint32_t*>(hb + col) = h01;
      *reinterpret_cast<uint32_t*>(lb + col) = l01;
      *reinterpret_cast<uint32_t*>(hb + col + 8) = h89;
      *reinterpret_cast<uint32_t*>(lb + col + 8) = l89;
    }
  };
  publish(0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc)
      load_stage<T>(smem + s * S::BYTES, yi, st, cum, Cm, b, h, p0, s, L, nc, Q, H, P, N, ldc,
                    vec, tid);
    rt_cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    rt_cp_async_wait<STAGES - 2>();
    __syncthreads();    // chunk c and the carry entering it are in; stage c - 1 is free
    if (c + STAGES - 1 < nc)
      load_stage<T>(smem + ((c + STAGES - 1) % STAGES) * S::BYTES, yi, st, cum, Cm, b, h, p0,
                    c + STAGES - 1, L, nc, Q, H, P, N, ldc, vec, tid);
    rt_cp_async_commit();
    const unsigned char* sb = smem + (c % STAGES) * S::BYTES;
    const float* ss = reinterpret_cast<const float*>(sb);
    const T* cs = reinterpret_cast<const T*>(sb + S::ST);
    const T* ys = reinterpret_cast<const T*>(sb + S::ST + S::C);
    const float* us = reinterpret_cast<const float*>(sb + S::ST + S::C + S::Y);
    const int nv = L - c * Q < Q ? L - c * Q : Q;

    // the carry into chunk c + 1 first, published for the next read-out
    // (into the buffer read at c - 1: every warp is past the barrier
    // above), so its stores drain under this chunk's read-out
    const float dl = expf(us[nv - 1]);
    const float* sr = ss + prow * LDS + cq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 16 * (2 * mt + i);
      const float2 s01 = *reinterpret_cast<const float2*>(sr + col);
      const float2 s89 = *reinterpret_cast<const float2*>(sr + col + 8);
      car[i][0] = car[i][0] * dl + s01.x;
      car[i][1] = car[i][1] * dl + s01.y;
      car[i][2] = car[i][2] * dl + s89.x;
      car[i][3] = car[i][3] * dl + s89.y;
    }
    publish((c + 1) & 1);

    // read-out of the warp's 16 chunk rows against the 8 carry rows of jt.
    // mma.sync's latency is long, so the products go to eight accumulators
    // ((kk % 4) x {hi, lo}: chains of two), summed at the end
    if (16 * mt < nv) {
      const float e0 = expf(us[16 * mt + r0]), e1 = expf(us[16 * mt + r0 + 8]);
      const __nv_bfloat16* hb = hilo + (c & 1) * 2 * PT * LDH + (8 * jt + (lane & 7)) * LDH +
                                (lane >> 3) * 8;
      float part[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[i][k] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {   // k tiles 2 kp and 2 kp + 1
        if (2 * kp >= KT) continue;
        uint32_t bh[4], bl[4];
        rt_ldsm_x4(bh, hb + 32 * kp);
        rt_ldsm_x4(bl, hb + PT * LDH + 32 * kp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kk = 2 * kp + i;
          if (kk >= KT) continue;
          uint32_t ah[4], al[4];
          c_fragment<T>(cs, 16 * mt, 16 * kk, lane, ah, al);
          rt_mma_bf16(part[2 * (kk & 3)], ah, bh[2 * i], bh[2 * i + 1]);
          rt_mma_bf16(part[2 * (kk & 3) + 1], ah, bl[2 * i], bl[2 * i + 1]);
          if constexpr (sizeof(T) == 4)
            rt_mma_bf16(part[2 * (kk & 3) + 1], al, bh[2 * i], bh[2 * i + 1]);
        }
      }
      float acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = ((part[0][k] + part[1][k]) + (part[2][k] + part[3][k])) +
                 ((part[4][k] + part[5][k]) + (part[6][k] + part[7][k]));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 16 * mt + r0 + 8 * half;
        if (t >= nv) continue;
        const float e = half ? e1 : e0;
        T* yr = y + ((int64_t)b * L + (int64_t)c * Q + t) * HP + (int64_t)h * P + p0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = 8 * jt + cq + q;
          if (p0 + p >= P) continue;
          // y_intra and y_inter each in the input type, then added
          const float inter = to_f32(from_f32<T>(e * acc[2 * half + q]));
          yr[p] = from_f32<T>(to_f32(ys[t * S::LDY + p]) + inter);
        }
      }
    }
  }
  rt_cp_async_wait<0>();

  if (pr < P) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (2 * mt + i) + cq + (e & 1) + (e >> 1) * 8;
        if (n < N) fin[(((int64_t)b * H + h) * P + pr) * N + n] = from_f32<T>(car[i][e]);
      }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* yi, const void* st, const void* cum, const void* Cm, const void* s0,
           int s0_dtype, void* y, void* fin, int64_t B, int64_t L, int64_t Q, int64_t H,
           int64_t P, int64_t N, int64_t ldc, cudaStream_t s) {
  constexpr size_t smem = Stage<T>::STAGES * Stage<T>::BYTES + 2 * 2 * PT * LDH * 2;
  static bool opted_in = false;   // above 48 KB only after opting in, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(ssd_pass_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  constexpr int E = Stage<T>::E;
  const int vec = N % E == 0 && P % E == 0 && ldc % E == 0 && aligned16(yi) && aligned16(st) &&
                  aligned16(Cm);
  dim3 grid((unsigned)rt_cdiv(P, PT), (unsigned)H, (unsigned)B);
  ssd_pass_kernel<T><<<grid, NT, smem, s>>>(
      (const T*)yi, (const float*)st, (const float*)cum, (const T*)Cm, s0, s0_dtype, (T*)y,
      (T*)fin, (int)L, (int)rt_cdiv(L, Q), (int)Q, (int)H, (int)P, (int)N, ldc, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// yi, y: (B, L, H*P) of `dtype`, contiguous; st: (B, cdiv(L, Q), H*P, N)
// float32; cum: (B, L, H) float32; Cm: (B, L, N) of `dtype` with rows at
// stride ldc elements (batch stride L * ldc); s0: (B, H, P, N) float32 or
// bf16 (s0_dtype), or null for zeros; fin: (B, H, P, N) of `dtype`.
RT_EXPORT int rt_ssd_pass(const void* yi, const void* st, const void* cum, const void* Cm,
                          const void* s0, int s0_dtype, void* y, void* fin, int64_t B, int64_t L,
                          int64_t Q, int64_t H, int64_t P, int64_t N, int64_t ldc, int dtype,
                          void* stream) {
  if (B < 1 || L < 1 || H < 1 || Q < 1 || Q > QM || P < 1 || N < 1 || N > NM || ldc < N ||
      B > 65535 || H > 65535 || B * L > 2147483647 || H * P > 2147483647 ||
      (s0 != nullptr && s0_dtype != DT_F32 && s0_dtype != DT_BF16))
    return RT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch<float>(yi, st, cum, Cm, s0, s0_dtype, y, fin, B, L, Q, H, P, N, ldc, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(yi, st, cum, Cm, s0, s0_dtype, y, fin, B, L, Q, H, P, N, ldc,
                                   s);
    default: return RT_BAD_ARGUMENT;
  }
}
