// K3 — one-sided put with thread-scope completion (P1).
//
// Replaces the TPU kernel repro/kernels/rma_put.py::ring_put (pallas_call at
// rma_put.py:47, body _put_kernel).  On the TPU every device starts one remote
// DMA into its ring neighbour's buffer and waits on that DMA's own send/recv
// semaphores, so completion is per transfer, not device-wide.  On one H100
// all ranks' windows are rows of one device tensor: a group of blocks per
// origin rank copies the origin's row into the target's row, and each block,
// once its stores are visible, adds one to the origin's per-(rank, stream)
// completion counter with release semantics.  A thread-scope flush of stream
// s (rdma.wait() at rma_put.py:38) is put_wait_kernel below: it waits, on the
// card, for the counters (·, s) to reach what the issued puts owe, and reads
// nothing else — never a device-wide synchronisation.
//
// Bound on an H100: bytes.  Every payload byte is read once and written once,
// and the copy moves 16-byte words whenever the pointers, strides and length
// allow it (the wrapper picks the widest unit that divides them all).
//
// Layout: src row r at src + r * src_stride; rank r with targets[r] >= 0
// writes its m units to dst + targets[r] * dst_stride + dst_off.  All sizes
// are in units of `unit` bytes.  Ranks ride gridDim.y, `blocks` blocks each.
#include "rt_common.cuh"

template <typename U>
__global__ void put_kernel(const U* src, int64_t src_stride, U* dst,
                           int64_t dst_stride, int64_t dst_off,
                           const int32_t* __restrict__ targets, int64_t m,
                           unsigned* __restrict__ counters, int n_streams, int stream) {
  const int r = blockIdx.y;
  const int t = targets[r];
  if (t < 0) return;
  const U* s = src + (int64_t)r * src_stride;
  U* d = dst + (int64_t)t * dst_stride + dst_off;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += step) {
    d[i] = s[i];
  }
  // completion: every thread's stores are made visible before the block's
  // release-add on the origin's (rank, stream) counter
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) rt_red_release_add(counters + (int64_t)r * n_streams + stream, 1u);
}

template <typename U>
static int launch(const void* src, int64_t src_stride, void* dst, int64_t dst_stride,
                  int64_t dst_off, const int32_t* targets, int64_t n, int64_t m, void* counters,
                  int n_streams, int stream, int blocks, cudaStream_t s) {
  dim3 grid((unsigned)blocks, (unsigned)n);
  put_kernel<U><<<grid, 256, 0, s>>>((const U*)src, src_stride, (U*)dst, dst_stride, dst_off,
                                     targets, m, (unsigned*)counters, n_streams, stream);
  return (int)cudaGetLastError();
}

RT_EXPORT int rt_put(const void* src, int64_t src_stride, void* dst, int64_t dst_stride,
                     int64_t dst_off, const int32_t* targets, int64_t n, int64_t m, int unit,
                     void* counters, int n_streams, int stream, int blocks, void* stream_ptr) {
  if (n < 1 || n > 65535 || m < 1 || blocks < 1 || stream < 0 || stream >= n_streams)
    return RT_BAD_ARGUMENT;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (unit) {
    case 16: return launch<uint4>(src, src_stride, dst, dst_stride, dst_off, targets, n, m,
                                  counters, n_streams, stream, blocks, s);
    case 8: return launch<uint2>(src, src_stride, dst, dst_stride, dst_off, targets, n, m,
                                 counters, n_streams, stream, blocks, s);
    case 4: return launch<uint32_t>(src, src_stride, dst, dst_stride, dst_off, targets, n, m,
                                    counters, n_streams, stream, blocks, s);
    case 2: return launch<uint16_t>(src, src_stride, dst, dst_stride, dst_off, targets, n, m,
                                    counters, n_streams, stream, blocks, s);
    case 1: return launch<uint8_t>(src, src_stride, dst, dst_stride, dst_off, targets, n, m,
                                   counters, n_streams, stream, blocks, s);
    default: return RT_BAD_ARGUMENT;
  }
}

// The completion half.  Thread r acquire-loads counter (r, stream) until it
// has reached owed[r] (wrap-safe: the difference, as a signed word, is not
// negative).  A count that is still short after RT_WAIT_SPINS polls adds one
// to *stalls and gives up rather than hanging the card; the substrate reads
// the stall count where it checks completion.  Bound: 4n bytes read, 4n
// compared — a launch, nothing more.
#define RT_MAX_WAIT_RANKS 256
#define RT_WAIT_SPINS (1u << 16)

struct RtOwed {
  unsigned v[RT_MAX_WAIT_RANKS];
};

__global__ void put_wait_kernel(const unsigned* __restrict__ counters, int n, int n_streams,
                                int stream, RtOwed owed, unsigned* __restrict__ stalls) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const unsigned* c = counters + (int64_t)r * n_streams + stream;
    unsigned spins = 0;
    while ((int)(rt_ld_acquire(c) - owed.v[r]) < 0) {
      if (++spins == RT_WAIT_SPINS) {
        atomicAdd(stalls, 1u);
        break;
      }
      __nanosleep(1000);
    }
  }
}

RT_EXPORT int rt_put_wait(const void* counters, int64_t n, int n_streams, int stream,
                          const uint32_t* owed, void* stalls, void* stream_ptr) {
  if (n < 1 || n > RT_MAX_WAIT_RANKS || stream < 0 || stream >= n_streams) return RT_BAD_ARGUMENT;
  RtOwed o;
  for (int64_t r = 0; r < n; ++r) o.v[r] = owed[r];
  put_wait_kernel<<<1, 256, 0, (cudaStream_t)stream_ptr>>>(
      (const unsigned*)counters, (int)n, n_streams, stream, o, (unsigned*)stalls);
  return (int)cudaGetLastError();
}
