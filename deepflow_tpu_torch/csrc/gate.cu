// A device-side gate: one thread that holds a stream until the host
// releases it, so the work the host enqueues behind it runs back to back.
//
// Not a port of a TPU kernel: an instrument of the flight recorder. In
// eager PyTorch the card executes a program's kernels as the host
// launches them, so two events around the launches span the host's
// launching, not the card's execution. With the gate in front, the host
// launches the whole program while the card waits, then sets the word;
// an event recorded after the gate and one after the program then
// bracket the program's kernels executing without gaps.
//
// The word lives in pinned host memory mapped into the device's address
// space (cudaHostAllocMapped) and is read through a volatile pointer. The
// gate opens when word >= ticket (tickets only grow, so a late gate never
// waits for a word already past it), or when %globaltimer has advanced
// past the timeout: a host that blocks while the gate holds (a full launch
// queue, a synchronizing call inside the program) is released by the
// timeout, and the gate reports it. results[ticket % slots] receives
// +ticket (opened by the host) or -ticket (timed out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void gate_kernel(const volatile int32_t* word, int32_t ticket,
                            unsigned long long timeout_ns,
                            volatile int32_t* results, int slots) {
  const unsigned long long t0 = global_ns();
  int32_t verdict = -ticket;
  for (;;) {
    if (*word >= ticket) {
      verdict = ticket;
      break;
    }
    if (global_ns() - t0 > timeout_ns) break;
    __nanosleep(256);
  }
  results[ticket % slots] = verdict;
  __threadfence_system();
}

}  // namespace

// One mapped, pinned host buffer of n int32 words, zeroed: *host is its
// host address, *dev the device's. Returns the CUDA error (0 on success).
extern "C" int df_gate_alloc(int n, void** host, void** dev) {
  void* h = nullptr;
  cudaError_t err = cudaHostAlloc(&h, (size_t)n * sizeof(int32_t),
                                  cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i) static_cast<int32_t*>(h)[i] = 0;
  void* d = nullptr;
  err = cudaHostGetDevicePointer(&d, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return (int)err;
  }
  *host = h;
  *dev = d;
  return 0;
}

extern "C" int df_gate_free(void* host) { return (int)cudaFreeHost(host); }

// Enqueue one gate on `stream`: word and results are device addresses of
// the mapped buffer, ticket > 0, timeout in nanoseconds of %globaltimer.
extern "C" int df_gate(const void* word, int ticket, long long timeout_ns,
                       void* results, int slots, void* stream) {
  gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const volatile int32_t*>(word), ticket,
      (unsigned long long)timeout_ns, static_cast<volatile int32_t*>(results),
      slots);
  return (int)cudaGetLastError();
}
