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

#include "rt_common.cuh"

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
