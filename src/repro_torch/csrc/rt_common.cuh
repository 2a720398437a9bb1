// Shared vocabulary of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel library is a plain C interface loaded with ctypes: pointers and
// the CUDA stream arrive as void*, sizes as int64_t, enums as int.  Each entry
// point launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of the launch (0 on success) or a negative code for arguments it
// refuses, so the Python wrapper can raise right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes (repro_torch.kernels.common.DTYPE_CODES)
enum RtDType { DT_F32 = 0, DT_F64 = 1, DT_F16 = 2, DT_BF16 = 3, DT_I32 = 4, DT_I64 = 5 };

// accumulate op codes (repro_torch.kernels.common.OP_CODES)
enum RtOp {
  OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_REPLACE = 3, OP_PROD = 4,
  OP_BAND = 5, OP_BOR = 6, OP_BXOR = 7
};

#define RT_BAD_ARGUMENT (-1)

static inline int64_t rt_cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Release/acquire words for flags and completion counters, at GPU scope.
__device__ __forceinline__ unsigned rt_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void rt_st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A load the compiler issues where it stands even when a later load makes
// it redundant: a guess fetched beside the word that decides whether it is
// needed.
__device__ __forceinline__ int32_t rt_ld_issued(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void rt_red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// NaN-propagating min/max, matching torch.minimum / torch.maximum.
template <typename F>
__device__ __forceinline__ F rt_fmin(F a, F b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}

template <typename F>
__device__ __forceinline__ F rt_fmax(F a, F b) {
  return (a != a || b != b) ? a + b : (b > a ? b : a);
}

// The accumulate op table on the card (repro_torch.kernels.common.combine_op):
// floats combine as torch does, integers wrap in two's complement.
template <typename T>
struct Combine {
  __device__ __forceinline__ static T apply(T a, T b, int op) {
    switch (op) {
      case OP_SUM: return a + b;
      case OP_MIN: return rt_fmin(a, b);
      case OP_MAX: return rt_fmax(a, b);
      case OP_PROD: return a * b;
      default: return b;  // OP_REPLACE (bitwise ops are refused for floats)
    }
  }
};

// integers: wrap-around sum/product in unsigned arithmetic (two's complement,
// as torch and jnp give), min/max/bitwise as is
template <typename I, typename U>
struct IntCombine {
  __device__ __forceinline__ static I apply(I a, I b, int op) {
    switch (op) {
      case OP_SUM: return (I)((U)a + (U)b);
      case OP_MIN: return b < a ? b : a;
      case OP_MAX: return b > a ? b : a;
      case OP_PROD: return (I)((U)a * (U)b);
      case OP_BAND: return a & b;
      case OP_BOR: return a | b;
      case OP_BXOR: return a ^ b;
      default: return b;  // OP_REPLACE
    }
  }
};

template <>
struct Combine<int32_t> : IntCombine<int32_t, uint32_t> {};
template <>
struct Combine<int64_t> : IntCombine<int64_t, uint64_t> {};

// half types combine in float and round once, as torch does on the CPU
template <>
struct Combine<__half> {
  __device__ __forceinline__ static __half apply(__half a, __half b, int op) {
    if (op == OP_REPLACE) return b;
    return __float2half(Combine<float>::apply(__half2float(a), __half2float(b), op));
  }
};
template <>
struct Combine<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b, int op) {
    if (op == OP_REPLACE) return b;
    return __float2bfloat16(
        Combine<float>::apply(__bfloat162float(a), __bfloat162float(b), op));
  }
};

// Tensor-core and async-copy building blocks (the SSD kernels): the warp-wide
// mma.sync m16n8k16 bf16 -> f32 product fed by ldmatrix, and cp.async copies
// of 16 or 4 bytes from global to shared memory that zero-fill instead of
// reading when `valid` is false (the source pointer must still be a mapped
// address then).
__device__ __forceinline__ uint32_t rt_smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void rt_cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(rt_smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void rt_cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(rt_smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void rt_cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void rt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Plain: lane t gets row t / 4, columns
// 2(t % 4) and 2(t % 4) + 1 of each; .trans: column t / 4, rows 2(t % 4) and
// 2(t % 4) + 1
__device__ __forceinline__ void rt_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(rt_smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void rt_ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(rt_smem_u32(p))
               : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate.  Lane
// t holds d rows t / 4 and t / 4 + 8, columns 2(t % 4) and 2(t % 4) + 1.
__device__ __forceinline__ void rt_mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t rt_pack_bf16x2(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two floats as bf16 pairs hi = bf16(v) and lo = bf16(v - hi) (the first
// value in the low half): hi + lo carries v to about 2^-16 relative, so a
// float32 operand multiplies an exact bf16 one in two products
__device__ __forceinline__ void rt_split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
