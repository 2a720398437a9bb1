// K4 — put+signal, and K6 — accumulate+signal: a payload and its doorbell in
// one launch (paper Listings 1 and 2, P2).
//
// K4 replaces the TPU kernel repro/kernels/ordered_put_signal.py::put_signal
// (pallas_call at ordered_put_signal.py:72, body _put_signal_kernel :33); K6
// replaces accumulate_signal (pallas_call at :144, body _acc_signal_kernel
// :86).  On the TPU the payload and the flag are two DMAs on one channel, and
// the flag starts once the payload's send has retired (ordered) or once the
// payload has completed at the target (unordered: the Listing-1 flush).
//
// On one H100 every rank's window is a row of one device tensor.  A group of
// `blocks` blocks per origin rank r moves r's payload into its target's row:
// K4 copies it (any dtype, in the widest word the layout allows), K6 folds it
// into the target row with one op of the atomic set.  A permutation sends at
// most one origin to a target word, so K6's plain load-op-store is exact and
// deterministic: no staging slot and no atomics.  Then the flag:
//
// * ordered (P2): every block makes its stores visible (__threadfence) and
//   arrives on the origin's counter; the last block to arrive fences again
//   and release-stores the flag words, then resets the counter.  Data before
//   flag holds with no grid-wide wait, and no block waits for another.
// * unordered (Listing 1): every block arrives on one grid-wide counter and
//   the flag writer of each origin waits until all payloads of the launch
//   have completed, the cost P2 removes.  The launch is cooperative, so every
//   block is resident and the wait cannot starve a block that was never
//   scheduled.
//
// The flag update is the window's declared op folded into the target's flag
// words (a signal is an accumulate), stored with st.release.gpu.
//
// A doorbell ordered behind another family's completion token (K4's `hold`:
// that family's stall word) is a promise that the family's flushed
// transfers have landed.  The flush wait gives up after a bounded spin and
// counts a stall instead of hanging, so the flag writer acquire-reads the
// hold word first: when it is not 0 the payload still lands, but the flag
// words stay as they are and the launch adds one to its own `stalls` for
// each flag so withheld.  A consumer then sees what the reference's flush,
// which never gives up, would show it: no doorbell.  Each
// payload block also release-adds one to the origin's (rank, stream)
// completion counter, as K3 does, so a later flush of that stream finds the
// transfer complete.
//
// Check mode (K4): the same instance and launch mode as the path's launch,
// with n consumer blocks first in the grid, so they are scheduled first and
// spin while the producers run.  The consumer of origin r acquire-spins on
// the first flag word of r's target until it is no longer 0, then reads the
// payload (ld.global.cg, never a stale L1 line) in the launch's copy unit
// and counts the units that differ from what r sent.  A reordering bug
// shows up as a count, not as a pass.  Ordered producers never wait, so a
// plain launch cannot starve them behind spinning consumers; the consumers'
// spins are bounded, and a flag never seen counts every unit.
//
// Bound on an H100: bytes.  K4 reads and writes the payload once; K6 reads
// the update and the target region and writes the region.  The flag is a
// few words; the ordered protocol adds one atomic per block.
#include "rt_common.cuh"

constexpr int kThreads = 256;
#define RT_SIGNAL_SPINS (1u << 22)

struct SigArgs {
  const void* src;        // (n, m) units, row stride src_stride
  int64_t src_stride;
  void* dst;              // target rows, row stride dst_stride
  int64_t dst_stride;
  int64_t dst_off;        // displacement of every origin (units) ...
  const int64_t* dst_offs;  // ... or one per origin when not null
  const int32_t* targets;   // origin -> target row, -1: sends nothing
  int n;
  int64_t m;              // payload units per origin
  int op;                 // K6's fold op
  const void* fval;       // (n, fw) flag words, row stride fval_stride
  int64_t fval_stride;
  void* fdst;             // flag rows, row stride fdst_stride
  int64_t fdst_stride;
  int64_t foff;
  int fw;
  int fdtype;
  int fop;
  unsigned* scratch;      // n arrival counters, then done / exit counters
  unsigned* counters;     // (n, n_streams) completion counters, or null
  int n_streams;
  int stream;
  int blocks;             // blocks per origin
  int ordered;
  unsigned* mismatch;     // check mode: units that differ (null: no check)
  unsigned* stalls;       // bounded spins that gave up, or null
  const unsigned* hold;   // K4: a stall word; the flags are withheld while it is not 0
};

template <typename F>
__device__ __forceinline__ void store_release(F* p, F v) {
  if constexpr (sizeof(F) == 8) {
    unsigned long long u;
    memcpy(&u, &v, 8);
    asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(u) : "memory");
  } else if constexpr (sizeof(F) == 4) {
    unsigned u;
    memcpy(&u, &v, 4);
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(u) : "memory");
  } else {
    unsigned short u;
    memcpy(&u, &v, 2);
    asm volatile("st.release.gpu.global.b16 [%0], %1;" ::"l"(p), "h"(u) : "memory");
  }
}

// a word read from L2 (another block may have written it), by its bits
template <typename F>
__device__ __forceinline__ F load_cg(const F* p) {
  F v;
  if constexpr (sizeof(F) == 8) {
    unsigned long long b = __ldcg(reinterpret_cast<const unsigned long long*>(p));
    memcpy(&v, &b, 8);
  } else if constexpr (sizeof(F) == 4) {
    unsigned b = __ldcg(reinterpret_cast<const unsigned*>(p));
    memcpy(&v, &b, 4);
  } else {
    unsigned short b = __ldcg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&v, &b, 2);
  }
  return v;
}

template <typename F>
__device__ __forceinline__ void flag_word(void* dst, const void* val, int64_t i, int op) {
  F* p = reinterpret_cast<F*>(dst) + i;
  store_release(p, Combine<F>::apply(load_cg(p), reinterpret_cast<const F*>(val)[i], op));
}

// The flag words of origin r, written by the calling block's first fw threads
// once every payload store of r is visible.
__device__ void raise_flag(const SigArgs& a, int r, int t) {
  const int es = a.fdtype == DT_F64 || a.fdtype == DT_I64 ? 8
                 : (a.fdtype == DT_F16 || a.fdtype == DT_BF16 ? 2 : 4);
  char* dst = (char*)a.fdst + ((int64_t)t * a.fdst_stride + a.foff) * es;
  const char* val = (const char*)a.fval + (int64_t)r * a.fval_stride * es;
  for (int i = threadIdx.x; i < a.fw; i += blockDim.x) {
    switch (a.fdtype) {
      case DT_F32: flag_word<float>(dst, val, i, a.fop); break;
      case DT_F64: flag_word<double>(dst, val, i, a.fop); break;
      case DT_F16: flag_word<__half>(dst, val, i, a.fop); break;
      case DT_BF16: flag_word<__nv_bfloat16>(dst, val, i, a.fop); break;
      case DT_I32: flag_word<int32_t>(dst, val, i, a.fop); break;
      default: flag_word<int64_t>(dst, val, i, a.fop); break;
    }
  }
}

// The flag writer's block: raise origin r's flag words, or, when the hold
// word says a flush this doorbell is ordered behind gave up, withhold them
// and count the stall.  `held` is shared by the block (thread 0 reads it).
__device__ void raise_or_hold(const SigArgs& a, int r, int t, int* held) {
  if (threadIdx.x == 0) *held = a.hold != nullptr && rt_ld_acquire(a.hold) != 0u;
  __syncthreads();
  if (*held) {
    if (threadIdx.x == 0 && a.stalls) atomicAdd(a.stalls, 1u);
    return;
  }
  raise_flag(a, r, t);
}

__device__ __forceinline__ bool spin_until(const unsigned* word, unsigned at_least,
                                           unsigned* stalls) {
  unsigned spins = 0;
  while (rt_ld_acquire(word) < at_least) {
    if (++spins == RT_SIGNAL_SPINS) {
      if (stalls) atomicAdd(stalls, 1u);
      return false;
    }
    __nanosleep(64);
  }
  return true;
}

__device__ __forceinline__ bool same(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}
__device__ __forceinline__ bool same(uint2 a, uint2 b) { return a.x == b.x && a.y == b.y; }
template <typename U>
__device__ __forceinline__ bool same(U a, U b) { return a == b; }

// check mode: consumer of origin r (see the header comment)
template <typename U>
__device__ void consume(const SigArgs& a, int r) {
  const int t = a.targets[r];
  if (t < 0) return;
  __shared__ int raised;
  if (threadIdx.x == 0) {
    const unsigned* flag = (const unsigned*)a.fdst + (int64_t)t * a.fdst_stride + a.foff;
    unsigned spins = 0;
    raised = 1;
    while (rt_ld_acquire(flag) == 0u) {
      if (++spins == RT_SIGNAL_SPINS) {
        raised = 0;
        break;
      }
      __nanosleep(64);
    }
  }
  __syncthreads();
  if (!raised) {
    if (threadIdx.x == 0) atomicAdd(a.mismatch, (unsigned)a.m);
    return;
  }
  const int64_t off = a.dst_offs ? a.dst_offs[r] : a.dst_off;
  const U* s = (const U*)a.src + (int64_t)r * a.src_stride;
  const U* d = (const U*)a.dst + (int64_t)t * a.dst_stride + off;
  unsigned differ = 0;
  for (int64_t i = threadIdx.x; i < a.m; i += blockDim.x) {
    if (!same(__ldcg(d + i), s[i])) ++differ;
  }
  if (differ) atomicAdd(a.mismatch, differ);
}

// payload: K4 copies units, K6 folds elements with the op
template <typename U, bool FOLD>
__device__ __forceinline__ void move(U* d, const U* s, int64_t i, int op) {
  if constexpr (FOLD) {
    d[i] = Combine<U>::apply(d[i], s[i], op);
  } else {
    d[i] = s[i];
  }
}

template <typename U, bool FOLD>
__global__ void __launch_bounds__(kThreads) signal_kernel(SigArgs a) {
  const int nb = a.blocks;
  const int producers = a.n * nb;
  const int consumers = a.mismatch ? a.n : 0;
  if ((int)blockIdx.x < consumers) {
    if constexpr (!FOLD) consume<U>(a, blockIdx.x);
    return;
  }
  const int b = blockIdx.x - consumers;
  const int r = b / nb;
  const int j = b % nb;
  const int t = a.targets[r];
  __shared__ int last, held;
  if (t >= 0) {
    const int64_t off = a.dst_offs ? a.dst_offs[r] : a.dst_off;
    const U* s = (const U*)a.src + (int64_t)r * a.src_stride;
    U* d = (U*)a.dst + (int64_t)t * a.dst_stride + off;
    const int64_t step = (int64_t)nb * blockDim.x;
    for (int64_t i = (int64_t)j * blockDim.x + threadIdx.x; i < a.m; i += step) {
      move<U, FOLD>(d, s, i, a.op);
    }
  }
  // every thread's payload stores are visible before the block arrives
  __threadfence();
  __syncthreads();
  if (a.ordered) {
    if (t < 0) return;
    if (threadIdx.x == 0) {
      if (a.counters) rt_red_release_add(a.counters + (int64_t)r * a.n_streams + a.stream, 1u);
      last = atomicAdd(a.scratch + r, 1u) == (unsigned)(nb - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();  // acquire side of the other blocks' fenced arrivals
    raise_or_hold(a, r, t, &held);
    if (threadIdx.x == 0) a.scratch[r] = 0u;  // ready for the next launch
    return;
  }
  // unordered: the grid-wide completion wait (Listing 1)
  unsigned* done = a.scratch + a.n;
  unsigned* exited = a.scratch + a.n + 1;
  if (threadIdx.x == 0) {
    if (t >= 0 && a.counters)
      rt_red_release_add(a.counters + (int64_t)r * a.n_streams + a.stream, 1u);
    rt_red_release_add(done, 1u);
  }
  if (j != 0) return;
  if (threadIdx.x == 0) spin_until(done, (unsigned)producers, a.stalls);
  __syncthreads();
  __threadfence();
  if (t >= 0) raise_or_hold(a, r, t, &held);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    // the last flag writer out resets both words for the next launch
    if (atomicAdd(exited, 1u) == (unsigned)(a.n - 1)) {
      *done = 0u;
      *exited = 0u;
    }
  }
}

template <typename U, bool FOLD>
static int launch(SigArgs a, cudaStream_t s) {
  const int consumers = a.mismatch ? a.n : 0;
  const unsigned grid = (unsigned)(a.n * a.blocks + consumers);
  if (a.ordered) {
    signal_kernel<U, FOLD><<<grid, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  // waits across blocks: every block must be resident at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, signal_kernel<U, FOLD>, kThreads,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  if ((int64_t)grid > (int64_t)sms * per_sm) return -2;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)signal_kernel<U, FOLD>, dim3(grid), dim3(kThreads),
                                  args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static bool flag_ok(const SigArgs& a) {
  const bool fbitwise = a.fop >= OP_BAND;
  const bool fint = a.fdtype == DT_I32 || a.fdtype == DT_I64;
  return a.fw >= 1 && a.fdtype >= DT_F32 && a.fdtype <= DT_I64 && a.fop >= OP_SUM &&
         a.fop <= OP_BXOR && a.fop != OP_PROD && (fint || !fbitwise);
}

static SigArgs make_args(const void* src, int64_t src_stride, void* dst, int64_t dst_stride,
                         int64_t dst_off, const int64_t* dst_offs, const int32_t* targets,
                         int64_t n, int64_t m, int op, const void* fval, int64_t fval_stride,
                         void* fdst, int64_t fdst_stride, int64_t foff, int64_t fw, int fdtype,
                         int fop, void* scratch, void* counters, int n_streams, int stream,
                         int blocks, int ordered, void* stalls) {
  SigArgs a;
  a.src = src;
  a.src_stride = src_stride;
  a.dst = dst;
  a.dst_stride = dst_stride;
  a.dst_off = dst_off;
  a.dst_offs = dst_offs;
  a.targets = targets;
  a.n = (int)n;
  a.m = m;
  a.op = op;
  a.fval = fval;
  a.fval_stride = fval_stride;
  a.fdst = fdst;
  a.fdst_stride = fdst_stride;
  a.foff = foff;
  a.fw = (int)fw;
  a.fdtype = fdtype;
  a.fop = fop;
  a.scratch = (unsigned*)scratch;
  a.counters = (unsigned*)counters;
  a.n_streams = n_streams;
  a.stream = stream;
  a.blocks = blocks;
  a.ordered = ordered;
  a.mismatch = nullptr;
  a.stalls = (unsigned*)stalls;
  a.hold = nullptr;
  return a;
}

// K4.  Sizes of the payload in units of `unit` bytes; flag sizes in flag
// words.  mismatch != null selects the check mode; hold != null withholds
// the flags while *hold is not 0.
RT_EXPORT int rt_put_signal(const void* src, int64_t src_stride, void* dst, int64_t dst_stride,
                            int64_t dst_off, const int64_t* dst_offs, const int32_t* targets,
                            int64_t n, int64_t m, int unit, const void* fval,
                            int64_t fval_stride, void* fdst, int64_t fdst_stride, int64_t foff,
                            int64_t fw, int fdtype, int fop, void* scratch, void* counters,
                            int n_streams, int stream, int blocks, int ordered,
                            void* mismatch, void* stalls, const void* hold,
                            void* stream_ptr) {
  if (n < 1 || n > 65535 || m < 0 || blocks < 1 || stream < 0 || stream >= n_streams ||
      fw > 1024)
    return RT_BAD_ARGUMENT;
  SigArgs a = make_args(src, src_stride, dst, dst_stride, dst_off, dst_offs, targets, n, m, 0,
                        fval, fval_stride, fdst, fdst_stride, foff, fw, fdtype, fop, scratch,
                        counters, n_streams, stream, blocks, ordered, stalls);
  if (!flag_ok(a)) return RT_BAD_ARGUMENT;
  a.hold = (const unsigned*)hold;
  if (mismatch) {
    // the consumer spins on one 32-bit flag word
    if (fdtype != DT_F32 && fdtype != DT_I32) return RT_BAD_ARGUMENT;
    a.mismatch = (unsigned*)mismatch;
  }
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (unit) {
    case 16: return launch<uint4, false>(a, s);
    case 8: return launch<uint2, false>(a, s);
    case 4: return launch<unsigned, false>(a, s);
    case 2: return launch<unsigned short, false>(a, s);
    case 1: return launch<unsigned char, false>(a, s);
    default: return RT_BAD_ARGUMENT;
  }
}

// K6.  Sizes in elements of `dtype`; op from the atomic set (no prod).
RT_EXPORT int rt_accumulate_signal(const void* upd, int64_t upd_stride, void* buf,
                                   int64_t buf_stride, int64_t off, const int64_t* offs,
                                   const int32_t* targets, int64_t n, int64_t m, int dtype,
                                   int op, const void* fval, int64_t fval_stride, void* fdst,
                                   int64_t fdst_stride, int64_t foff, int64_t fw, int fdtype,
                                   int fop, void* scratch, void* counters, int n_streams,
                                   int stream, int blocks, int ordered, void* stalls,
                                   void* stream_ptr) {
  if (n < 1 || n > 65535 || m < 0 || blocks < 1 || stream < 0 || stream >= n_streams ||
      fw > 1024 || op < OP_SUM || op > OP_BXOR || op == OP_PROD)
    return RT_BAD_ARGUMENT;
  SigArgs a = make_args(upd, upd_stride, buf, buf_stride, off, offs, targets, n, m, op, fval,
                        fval_stride, fdst, fdst_stride, foff, fw, fdtype, fop, scratch,
                        counters, n_streams, stream, blocks, ordered, stalls);
  if (!flag_ok(a)) return RT_BAD_ARGUMENT;
  const bool bitwise = op >= OP_BAND;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (dtype) {
    case DT_F32: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<float, true>(a, s);
    case DT_F64: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<double, true>(a, s);
    case DT_F16: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<__half, true>(a, s);
    case DT_BF16: if (bitwise) return RT_BAD_ARGUMENT;
      return launch<__nv_bfloat16, true>(a, s);
    case DT_I32: return launch<int32_t, true>(a, s);
    case DT_I64: return launch<int64_t, true>(a, s);
    default: return RT_BAD_ARGUMENT;
  }
}
