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
