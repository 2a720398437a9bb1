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
