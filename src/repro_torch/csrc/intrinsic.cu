// K2 — origin-issued atomic accumulate, the P3 latency path.
//
// Replaces the TPU kernel repro/kernels/intrinsic.py::ring_accumulate
// (pallas_call at intrinsic.py:90, body _acc_kernel).  On the TPU the origin
// DMAs its update into a staging slot at the target and the target folds it
// in with one VPU op.  On one H100 every rank's window is a row of one device
// tensor, so the origin needs no staging and no help from the target: each
// thread issues one hardware atomic straight at the target row — the paper's
// "intrinsic to the origin" accumulate.  Integer ops map to atomicAdd/Min/
// Max/And/Or/Xor/Exch; float sum/replace to atomicAdd/atomicExch; float
// min/max have no native atomic and use a compare-and-swap loop.
//
// A ring (any permutation) sends at most one origin to each target word, so
// the atomics never contend and the float sum is exact and deterministic.
//
// Bound on an H100: latency.  The path is routed here only for counts at or
// below the crossover (8 elements by default): one launch, one atomic per
// element, a few microseconds of launch and L2 round trip against a few
// nanoseconds of bytes.
//
// Layout: update (n, m) contiguous; rank r with targets[r] >= 0 folds
// update[r] into buf[targets[r] * buf_stride + offset + i].  Ranks ride
// gridDim.y.
#include "rt_common.cuh"

__device__ __forceinline__ void atomic_op(float* p, float v, int op) {
  switch (op) {
    case OP_SUM: atomicAdd(p, v); return;
    case OP_REPLACE: atomicExch(p, v); return;
    default: {  // OP_MIN / OP_MAX: CAS loop on the bit pattern
      int* w = (int*)p;
      int old = *w, assumed;
      do {
        assumed = old;
        float cur = __int_as_float(assumed);
        float nv = op == OP_MIN ? rt_fmin(cur, v) : rt_fmax(cur, v);
        if (__float_as_int(nv) == assumed) return;
        old = atomicCAS(w, assumed, __float_as_int(nv));
      } while (assumed != old);
    }
  }
}

__device__ __forceinline__ void atomic_op(double* p, double v, int op) {
  unsigned long long* w = (unsigned long long*)p;
  switch (op) {
    case OP_SUM: atomicAdd(p, v); return;
    case OP_REPLACE: atomicExch(w, (unsigned long long)__double_as_longlong(v)); return;
    default: {
      unsigned long long old = *w, assumed;
      do {
        assumed = old;
        double cur = __longlong_as_double((long long)assumed);
        double nv = op == OP_MIN ? rt_fmin(cur, v) : rt_fmax(cur, v);
        unsigned long long nb = (unsigned long long)__double_as_longlong(nv);
        if (nb == assumed) return;
        old = atomicCAS(w, assumed, nb);
      } while (assumed != old);
    }
  }
}

__device__ __forceinline__ void atomic_op(int32_t* p, int32_t v, int op) {
  switch (op) {
    case OP_SUM: atomicAdd(p, v); return;
    case OP_MIN: atomicMin(p, v); return;
    case OP_MAX: atomicMax(p, v); return;
    case OP_REPLACE: atomicExch(p, v); return;
    case OP_BAND: atomicAnd(p, v); return;
    case OP_BOR: atomicOr(p, v); return;
    default: atomicXor(p, v); return;  // OP_BXOR
  }
}

__device__ __forceinline__ void atomic_op(int64_t* p, int64_t v, int op) {
  unsigned long long* u = (unsigned long long*)p;
  unsigned long long uv = (unsigned long long)v;
  switch (op) {
    case OP_SUM: atomicAdd(u, uv); return;
    case OP_MIN: atomicMin((long long*)p, (long long)v); return;
    case OP_MAX: atomicMax((long long*)p, (long long)v); return;
    case OP_REPLACE: atomicExch(u, uv); return;
    case OP_BAND: atomicAnd(u, uv); return;
    case OP_BOR: atomicOr(u, uv); return;
    default: atomicXor(u, uv); return;  // OP_BXOR
  }
}

template <typename T>
__global__ void ring_acc_kernel(T* __restrict__ buf, int64_t buf_stride, int64_t offset,
                                const T* __restrict__ upd, int64_t m,
                                const int32_t* __restrict__ targets, int op) {
  const int r = blockIdx.y;
  const int t = targets[r];
  if (t < 0) return;
  T* dst = buf + (int64_t)t * buf_stride + offset;
  const T* src = upd + (int64_t)r * m;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += step) {
    atomic_op(dst + i, src[i], op);
  }
}

template <typename T>
static int launch(void* buf, int64_t buf_stride, int64_t offset, const void* upd, int64_t m,
                  const int32_t* targets, int64_t n, int op, cudaStream_t s) {
  dim3 grid((unsigned)rt_cdiv(m, 256) < 1024 ? (unsigned)rt_cdiv(m, 256) : 1024u, (unsigned)n);
  ring_acc_kernel<T><<<grid, 256, 0, s>>>((T*)buf, buf_stride, offset, (const T*)upd, m,
                                          targets, op);
  return (int)cudaGetLastError();
}

RT_EXPORT int rt_ring_accumulate(void* buf, int64_t buf_stride, int64_t offset, const void* upd,
                                 int64_t m, const int32_t* targets, int64_t n, int dtype, int op,
                                 void* stream) {
  // prod is not an atomic op (NICs do not multiply): the router never sends it here
  if (n < 1 || n > 65535 || m < 1 || op < OP_SUM || op > OP_BXOR || op == OP_PROD)
    return RT_BAD_ARGUMENT;
  const bool bitwise = op >= OP_BAND;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<float>(buf, buf_stride, offset, upd, m, targets, n, op, s);
    case DT_F64: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<double>(buf, buf_stride, offset, upd, m, targets, n, op, s);
    case DT_I32: return launch<int32_t>(buf, buf_stride, offset, upd, m, targets, n, op, s);
    case DT_I64: return launch<int64_t>(buf, buf_stride, offset, upd, m, targets, n, op, s);
    default: return RT_BAD_ARGUMENT;  // no 16-bit atomics in the envelope
  }
}
