// K2 — origin-issued atomic accumulate, the P3 latency path.
//
// Replaces the TPU kernel repro/kernels/intrinsic.py::ring_accumulate
// (pallas_call at intrinsic.py:90, body _acc_kernel).  On the TPU the origin
// DMAs its update into a staging slot at the target and the target folds it
// in with one VPU op.  On one H100 every rank's window is a row of one device
// tensor, so the origin needs no staging and no help from the target: each
// thread issues hardware reductions straight at the target row — the paper's
// "intrinsic to the origin" accumulate.  The reductions return nothing (PTX
// red): integer sum/min/max/and/or/xor and float sum; a float32 sum moves
// four words in one red.global.add.v4.f32 wherever the target is 16-byte
// aligned.  replace is an exchange; float min/max have no native
// reduction and use a compare-and-swap loop.
//
// A ring (any permutation) sends at most one origin to each target word, so
// the atomics never contend and the float sum is exact and deterministic.
//
// Bound on an H100: one launch.  The path is routed here only for counts at
// or below the crossover (8 elements by default): a few words per rank, so
// one block of 256 threads covers every rank's update (a thread per element,
// or per four float32 sums), where the first version gave each rank a block.
//
// Where the address comes from (the P5 path), as in K3 (csrc/rma_put.cu):
//   rows = offset + disp[r] * disp_unit + handles[r].offset
// for origin r, placed as lax.dynamic_update_slice places it when it has a
// device part (a negative row counts from the end once, then the row is
// clamped to [0, rows_total - m]);
// with regs, an update whose handle epoch (the origin's) is not the live
// one of the slot target t's own handle names is stale: it is dropped and
// adds one to err[t].
//
// Layout: update (n, m * inner) contiguous; origin r with targets[r] >= 0
// folds update[r] into buf[targets[r] * buf_stride + rows * inner + i].
#include "rt_common.cuh"

__device__ __forceinline__ void red_op(float* p, float v, int op) {
  switch (op) {
    case OP_SUM: asm volatile("red.relaxed.gpu.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory"); return;
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

__device__ __forceinline__ void red_op(double* p, double v, int op) {
  unsigned long long* w = (unsigned long long*)p;
  switch (op) {
    case OP_SUM: asm volatile("red.relaxed.gpu.global.add.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory"); return;
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

#define RT_RED(OPNAME, TYPE, CONSTRAINT, p, v) \
  asm volatile("red.relaxed.gpu.global." OPNAME "." TYPE " [%0], %1;" ::"l"(p), CONSTRAINT(v) : "memory")

__device__ __forceinline__ void red_op(int32_t* p, int32_t v, int op) {
  switch (op) {
    case OP_SUM: RT_RED("add", "s32", "r", p, v); return;
    case OP_MIN: RT_RED("min", "s32", "r", p, v); return;
    case OP_MAX: RT_RED("max", "s32", "r", p, v); return;
    case OP_REPLACE: atomicExch(p, v); return;
    case OP_BAND: RT_RED("and", "b32", "r", p, v); return;
    case OP_BOR: RT_RED("or", "b32", "r", p, v); return;
    default: RT_RED("xor", "b32", "r", p, v); return;  // OP_BXOR
  }
}

__device__ __forceinline__ void red_op(int64_t* p, int64_t v, int op) {
  switch (op) {
    case OP_SUM: RT_RED("add", "u64", "l", p, v); return;
    case OP_MIN: RT_RED("min", "s64", "l", p, v); return;
    case OP_MAX: RT_RED("max", "s64", "l", p, v); return;
    case OP_REPLACE: atomicExch((unsigned long long*)p, (unsigned long long)v); return;
    case OP_BAND: RT_RED("and", "b64", "l", p, v); return;
    case OP_BOR: RT_RED("or", "b64", "l", p, v); return;
    default: RT_RED("xor", "b64", "l", p, v); return;  // OP_BXOR
  }
}

__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

struct AccArgs {
  void* buf;
  int64_t buf_stride;  // elements from one rank's row to the next
  int64_t rows_total;  // rows of a window row (the clamp range)
  int64_t inner;       // elements of one displacement row
  int64_t offset;      // static displacement, rows
  const void* upd;
  int64_t m;           // rows each origin folds in
  const int32_t* targets;
  int n, op;
  const int32_t* disp;  // (n,) by origin, or null
  int64_t disp_unit;
  const int32_t* handles;  // (n, 4) by origin, or null
  const int32_t* regs;     // (n, max_attach, 3): the lifetime guard, or null
  int max_attach;
  unsigned* err;           // (n,) stale updates by target, or null
};

// Work item k covers `vec` elements of origin k / chunks (vec = 4 for a
// float32 sum, else 1).  Every thread resolves its origin's address itself.
// Its update words, its handle and the target map load together, before it
// knows whether the origin sends or the handle is fresh (none of their
// addresses depends on either); under the guard the target's handle and
// a registration entry load together, and a second entry only where the
// target's slot differs from the origin's.
template <typename T>
__global__ void ring_acc_kernel(AccArgs a, int vec) {
  const int len = (int)(a.m * a.inner);
  const int chunks = (len + vec - 1) / vec;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < a.n * chunks;
       k += gridDim.x * blockDim.x) {
    const int r = k / chunks;
    const int c = k - r * chunks;
    const T* src = (const T*)a.upd + (int64_t)r * len + (int64_t)c * vec;
    const bool quad = vec == 4 && c * 4 + 4 <= len;
    T x0 = src[0], x1 = T{}, x2 = T{}, x3 = T{};
    if (quad) {
      x1 = src[1];
      x2 = src[2];
      x3 = src[3];
    }
    const int4 h = a.handles ? reinterpret_cast<const int4*>(a.handles)[r] : make_int4(0, 0, 0, 0);
    const int t = a.targets[r];
    if (t < 0) continue;
    int64_t rows = a.offset + h.y;
    if (a.disp) rows += (int64_t)a.disp[r] * a.disp_unit;
    bool fresh = true;
    if (a.regs) {
      // the slot the target's own handle names, as the reference's guard
      // reads it at the target; the epoch is the origin's.  The entry of
      // the origin's slot (the same whenever every rank's handle names one
      // slot) is fetched in the same breath as the target's handle, and a
      // second load is paid only where the two slots differ
      const int32_t* entry = a.regs + (int64_t)t * a.max_attach * 3;
      const int guess = min(max(h.w, 0), a.max_attach - 1);
      int32_t live = rt_ld_issued(entry + guess * 3);
      const int slot =
          min(max(reinterpret_cast<const int4*>(a.handles)[t].w, 0), a.max_attach - 1);
      if (slot != guess) live = entry[slot * 3];
      fresh = h.x == live && live > 0;
    }
    if (a.disp || a.handles)
      rows = min(max(rows < 0 ? rows + a.rows_total : rows, (int64_t)0), a.rows_total - a.m);
    if (!fresh) {
      if (c == 0 && a.err) atomicAdd(a.err + t, 1u);
      continue;
    }
    T* dst = (T*)a.buf + (int64_t)t * a.buf_stride + rows * a.inner + (int64_t)c * vec;
    if (quad && ((uintptr_t)dst & 15) == 0) {
      red_add_v4((float*)dst, make_float4(x0, x1, x2, x3));
    } else if (quad) {
      red_op(dst, x0, a.op);
      red_op(dst + 1, x1, a.op);
      red_op(dst + 2, x2, a.op);
      red_op(dst + 3, x3, a.op);
    } else {
      red_op(dst, x0, a.op);
      for (int j = 1; j < vec && c * vec + j < len; ++j) red_op(dst + j, src[j], a.op);
    }
  }
}

template <typename T>
static int launch(const AccArgs& a, int vec, cudaStream_t s) {
  const int64_t items = (int64_t)a.n * ((a.m * a.inner + vec - 1) / vec);
  const int64_t blocks = rt_cdiv(items, 256) < 1024 ? rt_cdiv(items, 256) : 1024;
  ring_acc_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(a, vec);
  return (int)cudaGetLastError();
}

RT_EXPORT int rt_ring_accumulate(void* buf, int64_t buf_stride, int64_t rows_total, int64_t inner,
                                 int64_t offset, const void* upd, int64_t m,
                                 const int32_t* targets, int64_t n, int dtype, int op,
                                 const int32_t* disp, int64_t disp_unit, const int32_t* handles,
                                 const int32_t* regs, int max_attach, void* err, void* stream) {
  // prod is not an atomic op (NICs do not multiply): the router never sends it here
  if (n < 1 || n > 65535 || m < 1 || inner < 1 || rows_total < m || m * inner * n >= (1LL << 31) ||
      op < OP_SUM ||
      op > OP_BXOR || op == OP_PROD || (regs && (!handles || max_attach < 1)))
    return RT_BAD_ARGUMENT;
  const bool bitwise = op >= OP_BAND;
  AccArgs a{buf, buf_stride, rows_total, inner, offset, upd, m, targets, (int)n, op,
            disp, disp_unit, handles, regs, max_attach, (unsigned*)err};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<float>(a, op == OP_SUM ? 4 : 1, s);
    case DT_F64: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<double>(a, 1, s);
    case DT_I32: return launch<int32_t>(a, 1, s);
    case DT_I64: return launch<int64_t>(a, 1, s);
    default: return RT_BAD_ARGUMENT;  // no 16-bit atomics in the envelope
  }
}
