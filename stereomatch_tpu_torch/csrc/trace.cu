// Stage stamps and graph node counts for utils/profiling.py (sm_90a).
//
// Replaces no TPU kernel: the JAX package reads its stage times from
// XProf's device trace, which sees every launch of a compiled program.
// A CUDA graph replay shows no host range for its stages, so the port
// marks each stage boundary on the device itself.
//
// stamp_kernel: one thread reads %globaltimer (nanoseconds, one clock for
// the whole card) and writes one record {slot, time, frame, stage} into a
// ring of pinned host memory mapped into the device's address space
// (stm_stamp_ring_alloc).  The slot comes from a device-side cursor
// (state[0]), so the stamps of a replayed graph, whose launch arguments
// are frozen at capture, land in new slots at every replay; the frame's
// sequence number is a second counter (state[1]) that the stage-begin
// stamp (id 0) advances.  The host finds a stamp by its slot after an
// event recorded behind it: no copy to the host is enqueued, so the
// stamps are the only device operations tracing adds.  What bounds it is
// one launch and one 32-byte posted write over PCIe, a few microseconds
// in a stream's order.
//
// stm_graph_nodes: counts a captured cudaGraph_t's nodes by type, the
// device operations a replay runs.

#include <cuda_runtime.h>

#include <cstring>
#include <vector>

namespace {

struct Stamp {
  unsigned long long slot;
  unsigned long long time_ns;
  unsigned long long frame;
  unsigned long long stage;
};

__global__ void stamp_kernel(Stamp* ring, unsigned long long* state,
                             unsigned long long mask, unsigned int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(&state[0], 1ULL);
  const unsigned long long frame =
      stage == 0 ? atomicAdd(&state[1], 1ULL) + 1ULL
                 : atomicAdd(&state[1], 0ULL);
  Stamp* s = ring + (slot & mask);
  s->time_ns = now;
  s->frame = frame;
  s->stage = stage;
  s->slot = slot;
  __threadfence_system();
}

}  // namespace

// (ring, state, mask, stage, stream): one stamp on the stream.  ring is
// the device's view of the mapped host ring of mask + 1 records; state
// two zeroed 64-bit counters in device memory.
extern "C" int stm_stamp(void* ring, void* state, long long mask, int stage,
                         void* stream) {
  if (mask < 0 || stage < 0) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Stamp*>(ring), static_cast<unsigned long long*>(state),
      static_cast<unsigned long long>(mask), static_cast<unsigned>(stage));
  return static_cast<int>(cudaGetLastError());
}

// (bytes, host, device): zeroed pinned host memory, mapped (and portable
// to every device); its host address in *host, the device's in *device.
// It lives as long as the process.
extern "C" int stm_stamp_ring_alloc(long long bytes, void** host,
                                    void** device) {
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  void* h = nullptr;
  cudaError_t err = cudaHostAlloc(&h, static_cast<size_t>(bytes),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memset(h, 0, static_cast<size_t>(bytes));
  void* d = nullptr;
  err = cudaHostGetDevicePointer(&d, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return static_cast<int>(err);
  }
  *host = h;
  *device = d;
  return 0;
}

// (graph, counts): counts[0..3] = the graph's kernel, memcpy, memset and
// other nodes (empty, event, host, child graph...).
extern "C" int stm_graph_nodes(void* graph, long long* counts) {
  const auto g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(g, nodes.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int i = 0; i < 4; ++i) counts[i] = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (type) {
      case cudaGraphNodeTypeKernel:
        ++counts[0];
        break;
      case cudaGraphNodeTypeMemcpy:
        ++counts[1];
        break;
      case cudaGraphNodeTypeMemset:
        ++counts[2];
        break;
      default:
        ++counts[3];
    }
  }
  return 0;
}
