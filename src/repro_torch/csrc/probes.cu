// Measurement probes for chip_smoke.py; no module of the port loads this
// library.
//
// rt_empty: the launch floor that the smoke puts beside K2's and the flush
// wait's byte bounds — a kernel that does nothing, launched as K2 is
// (programmatic = 0) or as the wait is (1: programmatic stream
// serialization, and it ends, as the wait does, by waiting for the kernel
// before it).
//
// rt_graph_programmatic_edges: whether stream capture kept the wait's
// programmatic launch in a CUDA graph.
//
// rt_chase: the latency of one 16-byte read — one thread, a chain of
// `steps` loads where each address depends on the word the last one read
// (a multiple of 16 bytes from that word's top bit, which the compiler
// cannot know), about `stride` bytes apart round a `span`-byte buffer,
// bypassing the caches (ld.global.cv).  On K3's host path the buffer is
// pinned host memory at its device-mapped address: a read's round trip
// over the link, which with the link's rate gives the bytes in flight it
// needs (Little's law).
//
// rt_copy_loop: K3's copy loop at a chosen grid, 16-byte units from src to
// dst, each thread `unroll` loads (1, 2, 4 or 8) before its first store;
// unroll 1 is K3's own grid-stride loop (csrc/rma_put.cu::copy_units).
// Either side may be the device-mapped address of pinned host memory: the
// grid sweep of the host path, bytes in flight against the link's rate.
#include "rt_common.cuh"

__global__ void chase_kernel(const char* buf, int64_t span, int64_t stride, int steps,
                             unsigned* out) {
  int64_t off = 0;
  unsigned acc = 0;
  for (int i = 0; i < steps; ++i) {
    uint32_t x, y, z, w;
    asm volatile("ld.global.cv.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
                 : "l"(buf + off)
                 : "memory");
    acc += x ^ y ^ z ^ w;
    off = (off + stride + (int64_t)((x >> 31) << 4)) % span;  // 16-byte aligned, dependent
  }
  *out = acc;
}

RT_EXPORT int rt_chase(const void* buf, int64_t span, int64_t stride, int steps, void* out,
                       void* stream_ptr) {
  if (span < 16 || stride < 16 || (stride & 15) || (span & 15) || steps < 1) return RT_BAD_ARGUMENT;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream_ptr>>>((const char*)buf, span, stride, steps,
                                                      (unsigned*)out);
  return (int)cudaGetLastError();
}

template <int K>
__global__ void copy_loop_kernel(const uint4* s, uint4* d, int64_t m) {
  const int64_t chunk = (int64_t)K * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * chunk; base < m; base += (int64_t)gridDim.x * chunk) {
    uint4 v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < m) v[j] = s[i];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < m) d[i] = v[j];
    }
  }
}

RT_EXPORT int rt_copy_loop(const void* src, void* dst, int64_t nbytes, int blocks, int unroll,
                           void* stream_ptr) {
  if (nbytes < 16 || (nbytes & 15) || blocks < 1 || ((uintptr_t)src & 15) ||
      ((uintptr_t)dst & 15))
    return RT_BAD_ARGUMENT;
  const uint4* s = (const uint4*)src;
  uint4* d = (uint4*)dst;
  const int64_t m = nbytes / 16;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  switch (unroll) {
    case 1: copy_loop_kernel<1><<<blocks, 256, 0, st>>>(s, d, m); break;
    case 2: copy_loop_kernel<2><<<blocks, 256, 0, st>>>(s, d, m); break;
    case 4: copy_loop_kernel<4><<<blocks, 256, 0, st>>>(s, d, m); break;
    case 8: copy_loop_kernel<8><<<blocks, 256, 0, st>>>(s, d, m); break;
    default: return RT_BAD_ARGUMENT;
  }
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

RT_EXPORT int rt_empty(int programmatic, void* stream_ptr) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream_ptr;
  cfg.attrs = attr;
  cfg.numAttrs = programmatic ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// How many edges of a CUDA graph are programmatic (a kernel node that may
// start before its predecessor ends).  -2 where this toolkit cannot say.
RT_EXPORT int rt_graph_programmatic_edges(void* graph) {
#if CUDART_VERSION >= 12030
  size_t count = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphGetEdges((cudaGraph_t)graph, nullptr, nullptr, nullptr, &count);
#else
  cudaError_t e = cudaGraphGetEdges_v2((cudaGraph_t)graph, nullptr, nullptr, nullptr, &count);
#endif
  if (e != cudaSuccess) return -(int)e - 100;
  if (count == 0) return 0;
  cudaGraphNode_t* from = new cudaGraphNode_t[count];
  cudaGraphNode_t* to = new cudaGraphNode_t[count];
  cudaGraphEdgeData* data = new cudaGraphEdgeData[count];
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges((cudaGraph_t)graph, from, to, data, &count);
#else
  e = cudaGraphGetEdges_v2((cudaGraph_t)graph, from, to, data, &count);
#endif
  int programmatic = 0;
  for (size_t i = 0; e == cudaSuccess && i < count; ++i)
    programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  delete[] from;
  delete[] to;
  delete[] data;
  return e == cudaSuccess ? programmatic : -(int)e - 100;
#else
  (void)graph;
  return -2;
#endif
}
