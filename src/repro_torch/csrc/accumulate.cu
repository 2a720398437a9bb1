// K1 — tiled accumulate, the P3 bandwidth path: buffer op= update.
//
// Replaces the TPU kernel repro/kernels/accumulate.py::accumulate
// (pallas_call at accumulate.py:84, body _acc_kernel).  The TPU version tiles
// both operands through VMEM in `block`-sized tiles and pads a ragged tail
// with the op's identity element; here each thread of a grid-stride loop
// combines its own elements and the tail is simply masked, so no identity
// padding and no extra copy is needed.  The update lands in place on the
// buffer (the TPU kernel aliases its output onto the buffer).
//
// Bound on an H100: bytes.  Each element is read twice (buffer, update) and
// written once, one operation per element: at 3.35 TB/s a float32 element
// costs ~3.6 ps of memory time against ~0.015 ps of float32 ALU time.  So
// the design is all about the memory path:
// - 16-byte vectors (4 x f32/i32, 2 x f64/i64, 8 x f16/bf16) wherever a row
//   of the buffer and the same row of the update sit at the same offset
//   from a 16-byte boundary; scalar code takes the misaligned head and the
//   ragged tail, and a row whose two operands are misaligned differently;
// - one vector per operand a thread in flight (1 read faster than 2 or 4
//   in L2 and past it); blocks walk contiguous tiles of kThreads vectors;
// - a grid of the blocks the card holds at once, each walking tiles in a
//   loop, when both operands fit in L2, else one block a tile: the first is
//   fastest in L2 and the second past it (PERF.md, K1's findings);
// - one compiled kernel per (dtype, op): the op is a template argument, so
//   Combine's switch folds away at compile time.  Half types combine in
//   float and round once (Combine<__half>, Combine<__nv_bfloat16>).
//
// Layout: `rows` rows of `m` elements; row r of the buffer starts at
// buf + r * buf_stride, row r of the update at upd + r * upd_stride.  A 1-D
// accumulate is rows == 1; the substrate's tiled ring path folds all target
// rows of a window in one launch.  Rows ride gridDim.y.
#include "rt_common.cuh"

constexpr int kThreads = 256;

// one 16-byte vector of T, loaded and stored as one 128-bit access
template <typename T>
struct alignas(16) Vec16 {
  T e[16 / sizeof(T)];
};

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
acc_kernel(T* __restrict__ buf, int64_t buf_stride, const T* __restrict__ upd,
           int64_t upd_stride, int64_t m) {
  constexpr int V = 16 / sizeof(T);
  T* brow = buf + (int64_t)blockIdx.y * buf_stride;
  const T* urow = upd + (int64_t)blockIdx.y * upd_stride;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const uintptr_t bmis = (uintptr_t)brow % 16, umis = (uintptr_t)urow % 16;
  if (bmis != umis || bmis % sizeof(T) != 0) {
    for (int64_t i = tid; i < m; i += nthreads) brow[i] = Combine<T>::apply(brow[i], urow[i], OP);
    return;
  }
  // scalar head up to the first 16-byte boundary, then vectors, then the tail
  int64_t head = bmis ? (int64_t)((16 - bmis) / sizeof(T)) : 0;
  if (head > m) head = m;
  if (tid < head) brow[tid] = Combine<T>::apply(brow[tid], urow[tid], OP);
  const int64_t nvec = (m - head) / V;
  Vec16<T>* bv = reinterpret_cast<Vec16<T>*>(brow + head);
  const Vec16<T>* uv = reinterpret_cast<const Vec16<T>*>(urow + head);
  // a block walks contiguous tiles of kThreads vectors, so the grid
  // streams one window of the row at a time
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < nvec;
       j += (int64_t)gridDim.x * kThreads) {
    Vec16<T> a = bv[j];
    const Vec16<T> b = uv[j];
#pragma unroll
    for (int e = 0; e < V; ++e) a.e[e] = Combine<T>::apply(a.e[e], b.e[e], OP);
    bv[j] = a;
  }
  const int64_t tail = head + nvec * V + tid;
  if (tail < m) brow[tail] = Combine<T>::apply(brow[tail], urow[tail], OP);
}

template <typename T, int OP>
static int launch(void* buf, int64_t buf_stride, const void* upd, int64_t upd_stride,
                  int64_t rows, int64_t m, cudaStream_t stream) {
  // blocks the card holds at once and its L2 bytes, found once an instance
  static int resident = 0, l2 = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, acc_kernel<T, OP>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm;
  }
  constexpr int64_t V = 16 / sizeof(T);
  const int64_t want = rt_cdiv(rt_cdiv(m, V), (int64_t)kThreads);
  // operands that fit in L2 go fastest on the resident grid, each block
  // walking tiles; past L2, one block a tile streams HBM faster
  const bool fits = 2 * rows * m * (int64_t)sizeof(T) <= l2;
  int64_t per_row = fits ? resident / rows : want;
  if (per_row < 1) per_row = 1;
  if (per_row > want) per_row = want;
  dim3 grid((unsigned)per_row, (unsigned)rows);
  acc_kernel<T, OP><<<grid, kThreads, 0, stream>>>((T*)buf, buf_stride, (const T*)upd,
                                                   upd_stride, m);
  return (int)cudaGetLastError();
}

// the op as a compile-time argument: one instance per (dtype, op)
template <typename T, bool kBitwise>
static int dispatch_op(void* buf, int64_t bs, const void* upd, int64_t us, int64_t rows,
                       int64_t m, int op, cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch<T, OP_SUM>(buf, bs, upd, us, rows, m, s);
    case OP_MIN: return launch<T, OP_MIN>(buf, bs, upd, us, rows, m, s);
    case OP_MAX: return launch<T, OP_MAX>(buf, bs, upd, us, rows, m, s);
    case OP_REPLACE: return launch<T, OP_REPLACE>(buf, bs, upd, us, rows, m, s);
    case OP_PROD: return launch<T, OP_PROD>(buf, bs, upd, us, rows, m, s);
    default: break;
  }
  if constexpr (kBitwise) {
    switch (op) {
      case OP_BAND: return launch<T, OP_BAND>(buf, bs, upd, us, rows, m, s);
      case OP_BOR: return launch<T, OP_BOR>(buf, bs, upd, us, rows, m, s);
      case OP_BXOR: return launch<T, OP_BXOR>(buf, bs, upd, us, rows, m, s);
      default: break;
    }
  }
  return RT_BAD_ARGUMENT;  // bitwise ops are refused for floats
}

RT_EXPORT int rt_accumulate(void* buf, int64_t buf_stride, const void* upd, int64_t upd_stride,
                            int64_t rows, int64_t m, int dtype, int op, void* stream) {
  if (rows < 1 || rows > 65535 || m < 1 || op < OP_SUM || op > OP_BXOR) return RT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: return dispatch_op<float, false>(buf, buf_stride, upd, upd_stride, rows, m, op, s);
    case DT_F64: return dispatch_op<double, false>(buf, buf_stride, upd, upd_stride, rows, m, op, s);
    case DT_F16: return dispatch_op<__half, false>(buf, buf_stride, upd, upd_stride, rows, m, op, s);
    case DT_BF16:
      return dispatch_op<__nv_bfloat16, false>(buf, buf_stride, upd, upd_stride, rows, m, op, s);
    case DT_I32: return dispatch_op<int32_t, true>(buf, buf_stride, upd, upd_stride, rows, m, op, s);
    case DT_I64: return dispatch_op<int64_t, true>(buf, buf_stride, upd, upd_stride, rows, m, op, s);
    default: return RT_BAD_ARGUMENT;
  }
}
