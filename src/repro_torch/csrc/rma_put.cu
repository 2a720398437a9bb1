// K3 — one-sided put with thread-scope completion (P1), and its flush wait.
//
// Replaces the TPU kernel repro/kernels/rma_put.py::ring_put (pallas_call at
// rma_put.py:47, body _put_kernel).  On the TPU every device starts one remote
// DMA into its ring neighbour's buffer and waits on that DMA's own send/recv
// semaphores, so completion is per transfer, not device-wide.  On one H100
// all ranks' windows are rows of one device tensor: a group of blocks per
// sending rank copies its row into the receiving rank's row, and each block,
// once its stores are visible, adds one to the sender's per-(rank, stream)
// completion counter with release semantics.  A thread-scope flush of stream
// s (rdma.wait() at rma_put.py:38) is put_wait_kernel below: it waits, on the
// card, for the counters (., s) to reach what the issued puts owe, and reads
// nothing else — never a device-wide synchronisation.
//
// Bound on an H100: bytes.  Every payload byte is read once and written once.
// Each block picks the widest copy unit (16 bytes down to 1) that divides its
// source and destination addresses and the length, on the card, so a
// displacement read from device memory keeps 16-byte words wherever it lands
// on a 16-byte boundary.
//
// Where the address comes from (the P5 path).  A window operation's
// displacement may live in device memory, so that an operation is one launch
// and the host never reads it:
//   rows = offset + disp[o] * disp_unit + handles[o].offset
// where o is the operation's origin: the sender of a put, the receiver of a
// read's response (read = 1).  offset is the host's static part (rows); disp
// an optional int32 (n,) vector; handles an optional int32 (n, 4) table of
// memory handles [epoch, offset, size, slot].  A displacement with a device
// part is placed as lax.dynamic_update_slice and lax.dynamic_slice place it
// in the JAX package: a negative row counts from the end of the window row
// (once), then the row is clamped to [0, span - m]; a static one was checked
// by the wrapper.  With regs (int32 (n, max_attach, 3) registration tables) the
// kernel guards the handle's lifetime: the handle's epoch must equal the live
// entry regs[w, slot, 0] > 0 of the rank w whose window the operation
// addresses.  The slot is the one w's own handle names (handles[w].slot):
// the reference checks the epoch that rode the packet against the slot of
// the target's own handle (self.handle[3] in _lifetime_guard,
// repro/core/rma/memhandle.py:168-177); only the epoch and the offset come
// from the origin's handle.  A stale put writes nothing, a stale read's
// response writes zeros, and either adds one to err[w] — the target's
// count, as the JAX memory-handle window counts it.
//
// A window row may also lie in pinned host memory (the tiered KV pool's
// cold tier): src or dst is then the device-mapped address of that memory,
// which rt_host_device_pointer below gives once per buffer, and each copy
// unit crosses the host link.  Nothing else changes: the control words
// (targets, handles, regs, err, counters) stay in device memory, and every
// byte offset is 64-bit (a 512-page qwen3-4b host pool is 1.2e9 bytes).
// The same loop serves it: past ~130 KB of reads in flight (this launch
// keeps 589 KB at a page) the SMs' reads over the link stop at one rate per
// host machine, whatever the grid, the loads a thread keeps in flight, the
// load flavour or a bulk copy (PERF.md §6, the K3 host row).
//
// Layout: sender row r at src + r * src_stride, receiver row t = targets[r]
// at dst + t * dst_stride (bytes).  A put writes m rows of row_bytes at the
// resolved row of dst; a read's response reads them at the resolved row of
// src and writes row 0 of dst.  Senders ride gridDim.y, `blocks` blocks each.
#include "rt_common.cuh"

struct PutArgs {
  const char* src;
  char* dst;
  int64_t src_stride, dst_stride;  // bytes from one rank's row to the next
  int64_t row_bytes;               // bytes of one displacement row
  int64_t m;                       // rows each sender moves
  int64_t span;                    // rows of the addressed window row (the clamp range)
  int64_t offset;                  // static displacement, rows
  const int32_t* targets;          // (n,) sender -> receiver; -1 sends nothing
  const int32_t* disp;             // (n,) by origin, or null
  int64_t disp_unit;
  const int32_t* handles;          // (n, 4) by origin, or null
  const int32_t* regs;             // (n, max_attach, 3): the lifetime guard, or null
  int max_attach;
  unsigned* err;                   // (n,) stale operations by window rank, or null
  int read;                        // 1: a read's response (displacement on the source)
  unsigned* counters;              // (n, n_streams) completion counters
  int n_streams, stream;
};

// Programmatic dependent launch: a kernel launched behind this one with
// programmatic stream serialization (the flush wait) may start once every
// block of this grid has passed this point.
__device__ __forceinline__ void rt_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The dependent's half: block until every grid this one was launched behind
// has completed and its stores are visible.  A kernel launched with
// programmatic stream serialization must pass it before it ends, or its own
// completion would not imply its predecessor's, and a kernel queued after it
// in the ordinary way could overlap that predecessor.
__device__ __forceinline__ void rt_wait_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Each thread loads its word before it knows whether the handle is fresh
// (the source address never depends on the guard), so the source loads
// overlap the registration lookup; a fresh operation stores the word, a
// stale read's response stores zeros, a stale put stores nothing.
template <typename U>
__device__ __forceinline__ void copy_units(const char* s, char* d, int64_t nbytes, bool fresh,
                                           bool zero) {
  const U* su = reinterpret_cast<const U*>(s);
  U* du = reinterpret_cast<U*>(d);
  const int64_t m = nbytes / (int64_t)sizeof(U);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += step) {
    const U v = su[i];
    if (fresh) du[i] = v;
    else if (zero) du[i] = U{};
  }
}

// the widest unit dividing every address and the length (uniform per block)
__device__ __forceinline__ int widest_unit(uint64_t bits) {
  return (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : (bits & 3) == 0 ? 4 : (bits & 1) == 0 ? 2 : 1;
}

__global__ void put_kernel(PutArgs a) {
  rt_launch_dependents();
  const int r = blockIdx.y;
  // this block's sender's handle row loads beside the target map: a put's
  // origin, a read's addressed rank; the receiver's row only after it
  const int4* hs = reinterpret_cast<const int4*>(a.handles);
  int4 hr = make_int4(0, 0, 0, 0), ht = hr;
  if (hs) hr = hs[r];
  const int t = a.targets[r];
  if (t < 0) return;
  const int w = a.read ? r : t;  // the rank whose window the operation addresses
  // the guard's slot is the one w's own handle names.  A put reads that
  // handle (the target's) only now, so the entry of the sender's slot (the
  // same whenever every rank's handle names one slot, as memhandle_create
  // gives) is fetched in the same breath, and a second load is paid only
  // where the two slots differ
  const int32_t* entry = a.regs ? a.regs + (int64_t)w * a.max_attach * 3 : nullptr;
  const int guess = min(max(hr.w, 0), a.max_attach - 1);
  int32_t live = 0;
  if (entry) live = rt_ld_issued(entry + guess * 3);
  if (hs && (a.read || a.regs)) ht = hs[t];
  const int4 ho = a.read ? ht : hr;  // the origin's handle: epoch and offset
  int64_t rows = a.offset + ho.y;
  if (a.disp) rows += (int64_t)a.disp[a.read ? t : r] * a.disp_unit;
  bool fresh = true;
  if (entry) {
    const int slot = min(max((a.read ? hr : ht).w, 0), a.max_attach - 1);
    if (slot != guess) live = entry[slot * 3];
    fresh = ho.x == live && live > 0;
  }
  if (a.disp || a.handles)
    rows = min(max(rows < 0 ? rows + a.span : rows, (int64_t)0), a.span - a.m);
  const int64_t at = rows * a.row_bytes;
  const char* s = a.src + (int64_t)r * a.src_stride + (a.read ? at : 0);
  char* d = a.dst + (int64_t)t * a.dst_stride + (a.read ? 0 : at);
  const int64_t nbytes = a.m * a.row_bytes;
  const bool zero = a.read != 0;
  switch (widest_unit((uint64_t)s | (uint64_t)d | (uint64_t)nbytes)) {
    case 16: copy_units<uint4>(s, d, nbytes, fresh, zero); break;
    case 8: copy_units<uint2>(s, d, nbytes, fresh, zero); break;
    case 4: copy_units<uint32_t>(s, d, nbytes, fresh, zero); break;
    case 2: copy_units<uint16_t>(s, d, nbytes, fresh, zero); break;
    default: copy_units<uint8_t>(s, d, nbytes, fresh, zero); break;
  }
  if (!fresh && a.err && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.err + w, 1u);
  // completion: every thread's stores are made visible before the block's
  // release-add on the sender's (rank, stream) counter
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    rt_red_release_add(a.counters + (int64_t)r * a.n_streams + a.stream, 1u);
}

RT_EXPORT int rt_put(const void* src, int64_t src_stride, void* dst, int64_t dst_stride,
                     int64_t row_bytes, int64_t m, int64_t span, int64_t offset,
                     const int32_t* targets, int64_t n, const int32_t* disp, int64_t disp_unit,
                     const int32_t* handles, const int32_t* regs, int max_attach, void* err,
                     int read, void* counters, int n_streams, int stream, int blocks,
                     void* stream_ptr) {
  if (n < 1 || n > 65535 || m < 1 || row_bytes < 1 || span < m || blocks < 1 || stream < 0 ||
      stream >= n_streams || (regs && (!handles || max_attach < 1)))
    return RT_BAD_ARGUMENT;
  PutArgs a{(const char*)src, (char*)dst, src_stride, dst_stride, row_bytes, m, span, offset,
            targets, disp, disp_unit, handles, regs, max_attach, (unsigned*)err, read,
            (unsigned*)counters, n_streams, stream};
  put_kernel<<<dim3((unsigned)blocks, (unsigned)n), 256, 0, (cudaStream_t)stream_ptr>>>(a);
  return (int)cudaGetLastError();
}

// The completion half.  Thread r acquire-loads counter (r, stream) until it
// has reached owed[r] (wrap-safe: the difference, as a signed word, is not
// negative).  It is launched with programmatic stream serialization, so it
// may start while the put that precedes it still runs (the put's blocks
// release it at their first instruction): the acquire spin is then the real
// completion test of the stream's puts.  Every thread then passes
// griddepcontrol.wait, so the wait ends only after the kernel before it on
// the CUDA stream has ended: stream order holds across the wait whatever
// that kernel was (a put on another stream's counters, a same-host put no
// flush owes, a put the spin gave up on), and a kernel launched after the
// wait in the ordinary way never overlaps it.  The back-off starts at 32 ns
// and doubles to 256 ns.  A count still short after RT_WAIT_SPINS polls
// (~70 ms) adds one to *stalls and gives up rather than hanging the card;
// the substrate reads the stall count where it checks completion.  Bound:
// 4n bytes read, 4n compared — a launch, nothing more.
#define RT_MAX_WAIT_RANKS 256
#define RT_WAIT_SPINS (1u << 18)

struct RtOwed {
  unsigned v[RT_MAX_WAIT_RANKS];
};

__global__ void put_wait_kernel(const unsigned* __restrict__ counters, int n, int n_streams,
                                int stream, RtOwed owed, unsigned* __restrict__ stalls) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const unsigned* c = counters + (int64_t)r * n_streams + stream;
    unsigned spins = 0, ns = 32;
    while ((int)(rt_ld_acquire(c) - owed.v[r]) < 0) {
      if (++spins == RT_WAIT_SPINS) {
        atomicAdd(stalls, 1u);
        break;
      }
      __nanosleep(ns);
      if (ns < 256) ns <<= 1;
    }
  }
  rt_wait_primary();
}

RT_EXPORT int rt_put_wait(const void* counters, int64_t n, int n_streams, int stream,
                          const uint32_t* owed, void* stalls, void* stream_ptr) {
  if (n < 1 || n > RT_MAX_WAIT_RANKS || stream < 0 || stream >= n_streams) return RT_BAD_ARGUMENT;
  RtOwed o;
  for (int64_t r = 0; r < n; ++r) o.v[r] = owed[r];
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream_ptr;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, put_wait_kernel, (const unsigned*)counters,
                                           (int)n, n_streams, stream, o, (unsigned*)stalls);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The device-visible address of pinned host memory (cudaHostAlloc'd by
// PyTorch's pinned allocator): K3's wrapper asks once per buffer, when a
// window over it is made, and passes the result as src or dst.
RT_EXPORT int rt_host_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}
