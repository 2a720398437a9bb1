// The host-link probes that benchmarks_torch/host_link.py runs beyond what
// chip_smoke.py measures: other ways the SMs could read pinned host memory
// over the link, none of which K3 uses.  host_link.py builds this file with
// the port's flags and header (repro_torch/csrc/rt_common.cuh) into the
// port's build directory.
//
// rt_bulk_read: the bulk-copy design — one thread a block keeps `stages`
// bulk copies (cp.async.bulk, the copy engine of the SM's TMA unit) of
// `stage_bytes` from `src` into shared memory in flight, completing on
// mbarriers, and stores each arrived stage to `dst` with a bulk copy back.
// Whether that unit reads device-mapped host memory at all is what it asks
// first: a wait that never completes gives up after a bounded spin and adds
// one to *fail instead of hanging the card.
#include "rt_common.cuh"

#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>

// rt_hint_read: the port's probe copy loop (rt_copy_loop: each thread
// `unroll` 16-byte loads before its stores) with the load's cache operator and L2 prefetch
// size set by `hint`: 0 none, 1 .L2::64B, 2 .L2::128B, 3 .L2::256B,
// 4 .nc.L2::256B, 5 .cg.L2::256B, 6 none after a bulk prefetch of the
// block's next chunk into L2 (cp.async.bulk.prefetch.L2, issued by thread
// 0 a chunk ahead) — which size of read request the card sends over the
// link for what the SMs ask.
template <int H>
__device__ __forceinline__ uint4 ld_hint(const uint4* p) {
  uint4 v;
  if constexpr (H == 0) {
    v = *p;
  } else if constexpr (H == 1) {
    asm volatile("ld.global.L2::64B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if constexpr (H == 2) {
    asm volatile("ld.global.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if constexpr (H == 3) {
    asm volatile("ld.global.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if constexpr (H == 4) {
    asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    asm volatile("ld.global.cg.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  }
  return v;
}

template <int H, int K>
__global__ void hint_read_kernel(const uint4* s, uint4* d, int64_t m) {
  const int64_t chunk = (int64_t)K * blockDim.x;
  const int64_t step = (int64_t)gridDim.x * chunk;
  auto prefetch = [&](int64_t at) {
    if (H == 6 && threadIdx.x == 0 && at < m) {
      const int64_t units = m - at < chunk ? m - at : chunk;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(s + at),
                   "r"((uint32_t)(units * 16))
                   : "memory");
    }
  };
  prefetch((int64_t)blockIdx.x * chunk);
  for (int64_t base = (int64_t)blockIdx.x * chunk; base < m; base += step) {
    prefetch(base + step);
    uint4 v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < m) v[j] = ld_hint<H == 6 ? 0 : H>(s + i);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < m) d[i] = v[j];
    }
  }
}

template <int H>
static void launch_hint(const uint4* s, uint4* d, int64_t m, int blocks, int unroll,
                        cudaStream_t st) {
  if (unroll >= 8)
    hint_read_kernel<H, 8><<<blocks, 256, 0, st>>>(s, d, m);
  else if (unroll >= 4)
    hint_read_kernel<H, 4><<<blocks, 256, 0, st>>>(s, d, m);
  else
    hint_read_kernel<H, 1><<<blocks, 256, 0, st>>>(s, d, m);
}

RT_EXPORT int rt_hint_read(const void* src, void* dst, int64_t nbytes, int blocks, int unroll,
                           int hint, void* stream_ptr) {
  if (nbytes < 16 || (nbytes & 15) || blocks < 1 || ((uintptr_t)src & 15) ||
      ((uintptr_t)dst & 15) || hint < 0 || hint > 6)
    return RT_BAD_ARGUMENT;
  const uint4* s = (const uint4*)src;
  uint4* d = (uint4*)dst;
  const int64_t m = nbytes / 16;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  switch (hint) {
    case 0: launch_hint<0>(s, d, m, blocks, unroll, st); break;
    case 1: launch_hint<1>(s, d, m, blocks, unroll, st); break;
    case 2: launch_hint<2>(s, d, m, blocks, unroll, st); break;
    case 3: launch_hint<3>(s, d, m, blocks, unroll, st); break;
    case 4: launch_hint<4>(s, d, m, blocks, unroll, st); break;
    case 5: launch_hint<5>(s, d, m, blocks, unroll, st); break;
    default: launch_hint<6>(s, d, m, blocks, unroll, st); break;
  }
  return (int)cudaGetLastError();
}

#define RT_BULK_MAX_STAGES 8
#define RT_BULK_SPINS (1u << 22)

__device__ __forceinline__ uint32_t probe_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void bulk_read_kernel(const char* src, char* dst, int64_t nbytes, int stage_bytes,
                                 int stages, unsigned* fail) {
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) uint64_t bar[RT_BULK_MAX_STAGES];
  if (threadIdx.x != 0) return;
  for (int k = 0; k < stages; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(probe_smem(&bar[k])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const int64_t chunks = (nbytes + stage_bytes - 1) / stage_bytes;
  const int64_t first = blockIdx.x, step = gridDim.x;
  auto bytes_of = [&](int64_t c) {
    const int64_t left = nbytes - c * stage_bytes;
    return (uint32_t)(left < stage_bytes ? left : stage_bytes);
  };
  auto issue = [&](int64_t c, int k) {
    const uint32_t b = bytes_of(c), sb = probe_smem(&bar[k]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sb), "r"(b)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(probe_smem(ring + (int64_t)k * stage_bytes)),
        "l"(src + c * stage_bytes), "r"(b), "r"(sb)
        : "memory");
  };
  int k = 0;
  for (int64_t c = first, i = 0; c < chunks && i < stages; c += step, ++i) issue(c, (int)i);
  uint32_t phase[RT_BULK_MAX_STAGES] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int64_t c = first; c < chunks; c += step) {
    const uint32_t sb = probe_smem(&bar[k]);
    uint32_t done = 0, spins = 0;
    while (true) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(sb), "r"(phase[k])
          : "memory");
      if (done) break;
      if (++spins == RT_BULK_SPINS) {
        atomicAdd(fail, 1u);
        return;
      }
      __nanosleep(32);
    }
    phase[k] ^= 1u;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                     dst + c * stage_bytes),
                 "r"(probe_smem(ring + (int64_t)k * stage_bytes)), "r"(bytes_of(c))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    const int64_t next = c + (int64_t)stages * step;
    if (next < chunks) issue(next, k);
    k = k + 1 == stages ? 0 : k + 1;
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

RT_EXPORT int rt_bulk_read(const void* src, void* dst, int64_t nbytes, int stage_bytes,
                           int stages, int blocks, void* fail, void* stream_ptr) {
  if (nbytes < 16 || (nbytes & 15) || stage_bytes < 16 || (stage_bytes & 15) || stages < 1 ||
      stages > RT_BULK_MAX_STAGES || blocks < 1 || ((uintptr_t)src & 15) || ((uintptr_t)dst & 15))
    return RT_BAD_ARGUMENT;
  const int smem = stage_bytes * stages;
  if (smem > 227 * 1024) return RT_BAD_ARGUMENT;
  cudaError_t e = cudaFuncSetAttribute(bulk_read_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bulk_read_kernel<<<blocks, 32, smem, (cudaStream_t)stream_ptr>>>(
      (const char*)src, (char*)dst, nbytes, stage_bytes, stages, (unsigned*)fail);
  return (int)cudaGetLastError();
}

// rt_host_alloc / rt_host_free: pinned host memory of another kind than
// PyTorch's pinned allocator gives, to see what the link's reads depend on:
// kind 0 cudaHostAlloc(mapped), as that allocator; 1 cudaHostAlloc(mapped,
// write-combined: the card's reads of it are not snooped by the CPU's
// caches); 2 2 MiB-aligned memory advised to transparent huge pages, then
// cudaHostRegister(mapped).
RT_EXPORT int rt_host_alloc(int64_t bytes, int kind, void** out) {
  *out = nullptr;
  if (bytes < 1 || kind < 0 || kind > 2) return RT_BAD_ARGUMENT;
  if (kind < 2)
    return (int)cudaHostAlloc(out, (size_t)bytes,
                              cudaHostAllocMapped | (kind ? cudaHostAllocWriteCombined : 0));
  const size_t align = 2u << 20, size = ((size_t)bytes + align - 1) / align * align;
  void* p = aligned_alloc(align, size);
  if (!p) return RT_BAD_ARGUMENT;
  madvise(p, size, MADV_HUGEPAGE);
  memset(p, 0, size);
  const cudaError_t e = cudaHostRegister(p, size, cudaHostRegisterMapped);
  if (e != cudaSuccess) {
    free(p);
    return (int)e;
  }
  *out = p;
  return 0;
}

RT_EXPORT int rt_host_free(void* p, int kind) {
  if (kind < 2) return (int)cudaFreeHost(p);
  const cudaError_t e = cudaHostUnregister(p);
  free(p);
  return (int)e;
}
